"""SAI data-file reader for heif_enc sequence mode; counterpart of
tools/sai_datafile.py (reference: examples/SAI_datafile.{h,cc}).

The file has a header section (terminated by a `---` separator line)
declaring which sample-auxiliary-info kinds follow, then one CSV line
per sample per declared kind, round-robin:

    suid
    stai 0,1000000000,0,2
    ---
    urn:example:frame0
    123456789, 1, 0, 0
    urn:example:frame1
    123456790, 1, 0, 0

`suid` rows are GIMI sample content ids; `stai` rows are TAI
timestamps (tai_timestamp, synchronization_state,
timestamp_generation_failure, timestamp_is_modified).  The `stai`
header's CSV carries the track's TAI clock info (time_uncertainty,
clock_resolution, clock_drift_rate, clock_type).
"""

from __future__ import annotations

import sys
from typing import List, Optional


class SAIDatafile:
    def __init__(self):
        self.active_sais: List[str] = []
        self.tai_clock_info = None
        self.tai_timestamps: List[Optional[object]] = []
        self.gimi_content_ids: List[Optional[str]] = []

    # ---------------------------------------------------------- header

    def _handle_header(self, code: str, values: List[str]) -> None:
        if code == "suid":
            self.active_sais.append(code)
            if values:
                raise ValueError(
                    "Invalid 'suid' header line. May not have "
                    "additional parameters.")
        elif code == "stai":
            self.active_sais.append(code)
            if len(values) > 4:
                raise ValueError("Invalid 'stai' header line. May not "
                                 "have more than 4 parameters.")
            from ..api.tai_timestamps import (
                heif_tai_clock_info_alloc)
            info = heif_tai_clock_info_alloc()
            for i, v in enumerate(values):
                val = int(v)
                if i == 1 and not 0 <= val <= 0xFFFFFFFF:
                    raise ValueError("Invalid SAI tai clock info entry")
                if i == 2 and not 0 <= val <= 0x7FFFFFFF:
                    raise ValueError("Invalid SAI tai clock info entry")
                if i == 3 and not 0 <= val <= 0xFF:
                    raise ValueError("Invalid SAI tai clock info entry")
                attr = ("time_uncertainty", "clock_resolution",
                        "clock_drift_rate", "clock_type")[i]
                setattr(info, attr, val)
            self.tai_clock_info = info
        else:
            raise ValueError(
                f"Unknown code in SAI data file header: {code}")

    # ------------------------------------------------------------ main

    def _handle_main(self, values: List[str], line_no: int,
                     main_line: int) -> None:
        if not self.active_sais:
            raise ValueError(
                "Invalid SAI data file: data received, but no SAIs "
                "defined.")
        kind = self.active_sais[main_line % len(self.active_sais)]
        if kind == "suid":
            if len(values) > 1:
                raise ValueError(
                    f"Invalid SAI content-id entry in line {line_no}")
            self.gimi_content_ids.append(values[0] if values else None)
        elif kind == "stai":
            if len(values) > 4:
                raise ValueError(
                    f"Invalid SAI timestamp entry in line {line_no}")
            if not values:
                self.tai_timestamps.append(None)
                return
            from ..api.tai_timestamps import (
                heif_tai_timestamp_packet_alloc)
            tai = heif_tai_timestamp_packet_alloc()
            for i, v in enumerate(values):
                val = int(v)
                if 1 <= i <= 3 and not 0 <= val <= 1:
                    raise ValueError(
                        f"Invalid SAI timestamp entry in line {line_no}")
                attr = ("tai_timestamp", "synchronization_state",
                        "timestamp_generation_failure",
                        "timestamp_is_modified")[i]
                setattr(tai, attr, val)
            self.tai_timestamps.append(tai)

    # ------------------------------------------------------------ load

    @staticmethod
    def _split_csv(line: str) -> List[str]:
        return [p.strip() for p in line.split(",")]

    def load(self, path: str) -> "SAIDatafile":
        try:
            f = open(path)
        except OSError:
            print("Could not open SAI data file", file=sys.stderr)
            raise
        in_header = True
        main_line = 0
        with f:
            for line_no, line in enumerate(f.read().splitlines(), 1):
                if in_header and not line.strip():
                    continue
                if in_header and line.startswith("---"):
                    in_header = False
                    continue
                if in_header:
                    if len(line) < 4:
                        print(f"Invalid header line: {line}",
                              file=sys.stderr)
                        continue
                    code = line[:4]
                    rest = line[4:]
                    if rest[:1] in (" ", "\t"):
                        rest = rest[1:]
                    values = self._split_csv(rest) if rest else []
                    self._handle_header(code, values)
                else:
                    values = self._split_csv(line) if line.strip() \
                        else []
                    self._handle_main(values, line_no, main_line)
                    main_line += 1
        return self

    # --------------------------------------------------------- apply

    def apply_to_image(self, img, idx: int) -> None:
        """Attach the idx-th sample's aux infos to a frame image
        before track.add_frame (heif_enc.cc SAI usage)."""
        if idx < len(self.tai_timestamps) and \
                self.tai_timestamps[idx] is not None:
            img.tai_timestamp = self.tai_timestamps[idx]
        if idx < len(self.gimi_content_ids) and \
                self.gimi_content_ids[idx] is not None:
            img.gimi_sample_content_id = self.gimi_content_ids[idx]
