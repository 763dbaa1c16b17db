"""What the codecs' ``kernel_times.py`` scripts share: the device time of a
call, the card's name and power limit, ptxas's figures for a kernel, and
the runner that starts one process per checkout.

The scripts load this file by path from their own checkout (``load``),
not as part of the package: each worker process imports the package of
another checkout (ROOT), which may not have this module.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path


def load(name: str):
    """A module of this checkout's ``codecs`` directory (``name`` a path
    relative to it, as "unc/sass_count.py"), loaded by path under a
    private name."""
    path = Path(__file__).resolve().parent / name
    spec = importlib.util.spec_from_file_location(
        "_kernel_timing_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sleep_cycles_per_ms(torch) -> float:
    """Clock cycles a millisecond of ``torch.cuda._sleep`` on this card."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    e.synchronize()
    return 10_000_000 / s.elapsed_time(e)


def queued_ms(torch, fns, n, cycles_per_ms, tries=3):
    """Device time of a call: n calls (cycling through ``fns``) timed
    with CUDA events, queued behind a sleep kernel that holds the card
    while the host queues them, so host time between calls is not
    counted.  The sleep lasts twice the host's time for the calls in a
    warm run; where queuing outlasted the sleep (the card may then have
    waited for the host), the timing is repeated with a longer sleep,
    ``tries`` times in all."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fns[i % len(fns)]()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    for _ in range(tries):
        cycles = int(2 * host_ms * cycles_per_ms) + 100_000
        torch.cuda._sleep(cycles)
        s.record()
        t0 = time.perf_counter()
        for i in range(n):
            fns[i % len(fns)]()
        queued = (time.perf_counter() - t0) * 1e3
        e.record()
        e.synchronize()
        if queued < cycles / cycles_per_ms:
            break
        host_ms = queued
    return s.elapsed_time(e) / n


def device_ms(torch, fns, n):
    """``queued_ms`` with the sleep measured first."""
    return queued_ms(torch, fns, n, sleep_cycles_per_ms(torch))


def kernel_ms(torch, fns, n, name):
    """(kernel ms, copy ms): the mean device time of a launch of the
    kernels whose name holds ``name`` and of a memory copy, from
    torch.profiler over n calls (cycling through ``fns``); the kernel
    alone, without the copies and the gaps between them that
    ``device_ms`` counts.  Means over the events the profiler recorded,
    which may be fewer than the calls; None where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for f in fns:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e.time_range.elapsed_us() for e in dev if name in e.name]
    copies = [e.time_range.elapsed_us() for e in dev
              if e.name.startswith("Memcpy")]
    return (sum(kern) / 1e3 / len(kern) if kern else None,
            sum(copies) / 1e3 / len(copies) if copies else None)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"], capture_output=True, text=True,
        check=True).stdout.strip()


def ptxas_resources(build_log: str, kernel: str) -> dict:
    """{"regs", "smem", "stack"} (bytes for the last two) that ptxas
    reported in ``build_log`` for the entry function whose name holds
    ``kernel``; each None where the log does not give it (a library built
    by an earlier process)."""
    name, found = None, {}
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)", line)
        if m:
            name = m.group(1)
        if name is None or kernel not in name:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            found["stack"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            found["smem"] = int(sm.group(1)) if sm else 0
    return {k: found.get(k) for k in ("regs", "smem", "stack")}


def run(script: str, argv, worker, doc: str) -> int:
    """A kernel_times.py script's entry: ``--worker ROOT`` prints the JSON
    of ``worker(ROOT)``; otherwise each ROOT in turn runs in a process of
    its own (its working directory ROOT), one JSON line a run, then the
    runs as one JSON list."""
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(argv[1])))
        return 0
    if not argv:
        print(doc, file=sys.stderr)
        return 2
    runs = []
    for root in argv:
        out = subprocess.run(
            [sys.executable, os.path.abspath(script), "--worker",
             os.path.abspath(root)], cwd=os.path.abspath(root),
            capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        run_ = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(run_), flush=True)
        runs.append(run_)
    print(json.dumps(runs))
    return 0
