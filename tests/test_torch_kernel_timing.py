"""The measuring helpers of the port's timing scripts, on the CPU:
``codecs/kernel_timing.py`` (ptxas figures, the sleep-queued timer and
its retry, the runner's usage) and ``codecs/unc/sass_count.py`` (loop and
whole-function counts).  The card's numbers come from chip_smoke.py and
the codecs' kernel_times.py scripts."""

from __future__ import annotations

import time
import types

import pytest

from libheif_tpu_torch.codecs import kernel_timing as T
from libheif_tpu_torch.codecs.unc import sass_count

LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_18other_kEv' for 'sm_90a'
ptxas info    : Used 20 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124jpeg_dequant_idct_kernelEPKs' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_124jpeg_dequant_idct_kernelEPKs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 10752 bytes smem, 384 bytes cmem[0]
"""


def test_ptxas_resources_of_one_kernel():
    assert T.ptxas_resources(LOG, "jpeg_dequant_idct_kernel") == {
        "regs": 48, "smem": 10752, "stack": 0}
    assert T.ptxas_resources(LOG, "other_k") == {
        "regs": 20, "smem": 0, "stack": None}
    assert T.ptxas_resources("", "jpeg_dequant_idct_kernel") == {
        "regs": None, "smem": None, "stack": None}


SASS = """\
\t\tFunction : _Z6kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD R2, R3, R4, RZ ;
        /*0020*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0030*/              @P0  BRA 0x10 ;
        /*0040*/                   STG.E [R2.64], R3 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60;
        /*0070*/                   NOP;
"""


@pytest.mark.parametrize("whole, instructions", [(False, 3), (True, 6)])
def test_sass_count_loop_and_function(whole, instructions):
    c = sass_count.count(SASS, "kernel", 2, whole=whole)
    assert c["body_instructions"] == instructions
    assert c["per_pixel"] == instructions / 2


class FakeCuda:
    """The torch.cuda calls the timer makes, on the host clock: a sleep
    kernel of c cycles lasts c / 1e6 ms."""

    def __init__(self):
        self.sleeps = []
        outer = self

        class Event:
            def __init__(self, timing=False):
                self.t = 0.0

            def record(self):
                self.t = time.perf_counter() + outer.pending_ms / 1e3

            def synchronize(self):
                pass

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3

        self.Event = Event
        self.pending_ms = 0.0

    def synchronize(self):
        self.pending_ms = 0.0

    def _sleep(self, cycles):
        self.sleeps.append(cycles)
        self.pending_ms = cycles / 1e6


def test_queued_ms_repeats_when_the_host_falls_behind():
    """A call that is slow to queue only in the first timed pass makes the
    timer sleep longer and time again."""
    cuda = FakeCuda()
    torch = types.SimpleNamespace(cuda=cuda)
    calls = []

    def call():
        calls.append(1)
        if 4 <= len(calls) <= 5:       # the first timed pass
            time.sleep(0.05)
    T.queued_ms(torch, [call], 2, 1e6)
    assert len(cuda.sleeps) == 2 and cuda.sleeps[1] > cuda.sleeps[0]
    assert len(calls) == 1 + 2 + 2 + 2


def test_queued_ms_times_once_when_the_host_keeps_ahead():
    cuda = FakeCuda()
    torch = types.SimpleNamespace(cuda=cuda)
    T.queued_ms(torch, [lambda: None], 5, 1e6)
    assert len(cuda.sleeps) == 1


def test_runner_prints_its_usage_without_roots(capsys):
    assert T.run("kernel_times.py", [], lambda root: {}, "usage") == 2
    assert "usage" in capsys.readouterr().err


def test_load_reads_a_module_of_this_checkout():
    mod = T.load("unc/sass_count.py")
    assert mod.count(SASS, "kernel", 1, whole=True)["body_instructions"] == 6
