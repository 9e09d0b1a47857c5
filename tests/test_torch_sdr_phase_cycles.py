"""The SDR phase-cycle tool's source rewrite, on the CPU (the instrumented
kernels themselves build and run only on the card): every barrier of the
kernel, and no other, gets a timer; each site is named by its source line;
the rest of the source is unchanged."""

import os

import pytest

from srf_tpu_torch.ops import cuda_build
from srf_tpu_torch.tools import sdr_phase_cycles


def _source(name):
    with open(os.path.join(cuda_build.CSRC, name + ".cu")) as src:
        return src.read()


@pytest.mark.parametrize("name,kernel", sdr_phase_cycles.KERNELS)
def test_every_barrier_of_the_kernel_is_timed(name, kernel):
    source = _source(name)
    out, lines = sdr_phase_cycles.instrument(source, kernel)
    open_at, close_at = sdr_phase_cycles._body_span(source, kernel)
    assert len(lines) == source[open_at:close_at].count("__syncthreads();") > 0
    source_lines = source.splitlines()
    assert all("__syncthreads();" in source_lines[line - 1] for line in lines)
    assert out.count("ph_sum[%d] +=" % (len(lines) - 1)) == 1
    assert "ph_sum[%d] +=" % len(lines) not in out
    # barriers outside the kernel are left alone; the C interface remains
    assert (out.count("__syncthreads();")
            == source.count("__syncthreads();"))
    assert 'extern "C" int phase_read(long long* out)' in out
    assert out.startswith(source[:open_at].replace(
        "namespace {", "__device__ long long g_phase_cycles[%d];\n\n"
        "namespace {" % sdr_phase_cycles.MAX_SITES, 1))


def test_an_unknown_kernel_raises():
    with pytest.raises(ValueError, match="no definition"):
        sdr_phase_cycles.instrument(_source("sdr_fwd"), "no_such_kernel")
