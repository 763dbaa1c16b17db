"""WebVMT metadata-track support for heif_enc; counterpart of
tools/vmt.py (reference: examples/vmt.cc — encode_vmt_metadata_track).

Parses a WebVMT file (cue timestamps + sync commands) and writes the
metadata as a timed `urim` metadata sequence track next to a visual
track, with a `cdsc` track reference.  Two payload modes mirror the
reference: text mode extracts the `{"sync": {...}}` commands' data
fields (with `.hex` / `.base64` type suffixes decoded to binary), and
binary mode hex-decodes the cue body lines.
"""

from __future__ import annotations

import base64
import re
import sys
from typing import List, Optional, Tuple

_BAD_TS = 0xFFFFFFFE

_CUE = re.compile(r"^\s*(-?[\d:.]*)\s*-->\s*(-?[\d:.]*)?.*")
_NOTE = re.compile(r"^\s*(NOTE).*")
_SYNC = re.compile(r"\s*\{\s*\"sync\"\s*:\s*\{(.*?)\}\s*\}\s*", re.S)
_TYPE = re.compile(r".*\"type\"\s*:\s*\"(.*?)\".*", re.S)
_DATA = re.compile(r".*\"data\"\s*:\s*\"(.*?)\".*", re.S)
_TS = re.compile(r"-?((\d*):)?(\d\d):(\d\d)(\.(\d*))?")


def hex_to_binary(line: str) -> bytes:
    """Hex to raw bytes, ignoring any non-hex characters
    (vmt.cc hex_to_binary)."""
    digits = [c for c in line if c in "0123456789abcdefABCDEF"]
    if len(digits) % 2:
        digits = digits[:-1]
    return bytes(int(a + b, 16) for a, b in
                 zip(digits[0::2], digits[1::2]))


def parse_vmt_timestamp(ts: str) -> int:
    """[hh:]mm:ss[.mmm] to milliseconds; _BAD_TS on malformed
    fractional part (vmt.cc parse_vmt_timestamp)."""
    m = _TS.fullmatch(ts)
    if not m:
        return 0
    if "-" in ts:
        return 0
    hh, mm, ss, fs = m.group(2), m.group(3), m.group(4), m.group(6)
    ms = 0
    if fs:
        if len(fs) != 3:
            return _BAD_TS
        ms = int(fs)
    return ((int(hh) if hh else 0) * 3600 * 1000 +
            int(mm) * 60 * 1000 + int(ss) * 1000 + ms)


def parse_vmt_sync_data(content: str) -> bytes:
    """Collect the data payloads of all sync commands; `.hex` /
    `.base64` typed payloads are decoded (vmt.cc
    parse_vmt_sync_data)."""
    out = b""
    for m in _SYNC.finditer(content):
        sync = m.group(1)
        tm = _TYPE.match(sync)
        if not tm:
            continue
        typ = tm.group(1)
        dm = _DATA.match(sync)
        text = dm.group(1) if dm else ""
        if typ.endswith(".hex"):
            out += hex_to_binary(text)
        elif typ.endswith(".base64"):
            pad = text + "=" * (-len(text) % 4)
            try:
                out += base64.b64decode(pad)
            except Exception:   # noqa: BLE001 — mirror lenient decode
                pass
        else:
            out += text.encode()
    return out


def parse_vmt_file(path: str, binary: bool
                   ) -> List[Tuple[int, bytes]]:
    """(timestamp_ms, payload) pairs in file order."""
    cues: List[Tuple[int, bytes]] = []
    with open(path, "r", errors="replace") as f:
        lines = iter(f.read().splitlines())
    for line in lines:
        if _NOTE.match(line):
            for line in lines:
                if not line.strip():
                    break
            continue
        m = _CUE.match(line)
        if not m:
            continue
        ts = parse_vmt_timestamp(m.group(1))
        body: List[str] = []
        for line in lines:
            if not line.strip():
                break
            body.append(line)
        if binary:
            payload = b"".join(hex_to_binary(ln) for ln in body)
        else:
            content = "\n".join(body) + "\n"
            payload = parse_vmt_sync_data(content)
        if ts == _BAD_TS:
            print(f"Bad WebVMT timestamp: {m.group(1)}",
                  file=sys.stderr)
            continue
        cues.append((ts, payload))
    return cues


def encode_vmt_metadata_track(ctx, visual_track, vmt_metadata_file: str,
                              track_uri: str, binary: bool = False
                              ) -> None:
    """Add a urim metadata track carrying the WebVMT cues, referenced
    to `visual_track` via cdsc (vmt.cc encode_vmt_metadata_track)."""
    from ..sequences.track import RawSequenceSample

    tw = ctx.add_uri_metadata_track(track_uri, timescale=1000)
    prev_ts: Optional[int] = None
    prev_data = b""
    for ts, payload in parse_vmt_file(vmt_metadata_file, binary):
        if prev_ts is not None and ts > prev_ts:
            tw.add_raw_sample(RawSequenceSample(
                data=prev_data, duration=ts - prev_ts))
        elif prev_ts is not None and ts == prev_ts:
            payload = prev_data + payload
        elif prev_ts is not None:
            print(f"Bad WebVMT timestamp order at {ts}",
                  file=sys.stderr)
        prev_ts = ts
        prev_data = payload
    # flush the last packet with a nominal duration
    tw.add_raw_sample(RawSequenceSample(data=prev_data, duration=1))
    tw.add_reference_to_track(
        "cdsc", getattr(visual_track, "track_id", visual_track))
