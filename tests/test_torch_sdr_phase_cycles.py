"""The SDR phase-cycle tool's source rewrite, on the CPU (the instrumented
kernels themselves build and run only on the card): every block barrier of
the kernel, every cluster-barrier wait in its body (on both sides) and, in
the shared headers' helpers, every ring wait (on both sides) gets a timer,
and nothing else; each site is named by its file, source line and kind; the
rest of the source is unchanged."""

import os

import pytest

from srf_tpu_torch.ops import cuda_build
from srf_tpu_torch.tools import sdr_phase_cycles as tool


def _sources(name):
    sources = {}
    for file_name in (name + ".cu", tool.HEADER, tool.CLUSTER_HEADER):
        with open(os.path.join(cuda_build.CSRC, file_name)) as src:
            sources[file_name] = src.read()
    return sources


@pytest.mark.parametrize("name,kernel", tool.KERNELS)
def test_every_barrier_of_the_kernel_is_timed(name, kernel):
    sources = _sources(name)
    source = sources[name + ".cu"]
    copies, sites = tool.instrument(sources, name, kernel)
    open_at, close_at = tool._body_span(source, kernel)
    barriers = len(tool.BARRIER.findall(source[open_at:close_at]))
    assert barriers > 0
    assert [s for s in sites if s[0] == name + ".cu" and s[2] == "block"
            ] == sites[:barriers]
    lines = source.splitlines()
    assert all(tool.BARRIER.search(lines[line - 1])
               for _, line, _ in sites[:barriers])
    assert {kind for _, _, kind in sites} <= set(tool.KINDS)
    out = copies[name + ".cu"]
    assert "g_phase_cycles[%d] +=" % (len(sites) - 1) in "".join(
        copies.values())
    assert "g_phase_cycles[%d] +=" % len(sites) not in "".join(
        copies.values())
    # barriers outside the kernel are left alone; the C interface remains
    assert (len(tool.BARRIER.findall(out))
            == len(tool.BARRIER.findall(source)))
    assert 'extern "C" int phase_read(long long* out)' in out
    assert out.startswith(tool._DECL + source[:open_at])


@pytest.mark.parametrize("name,kernel", tool.KERNELS[:2])
def test_the_ring_waits_of_the_warp_passes_are_timed(name, kernel):
    sources = _sources(name)
    header = sources[tool.HEADER]
    copies, sites = tool.instrument(sources, name, kernel)
    waits = sum(
        len(tool.WAIT.findall(header[slice(*tool._body_span(header, f))]))
        for f in tool.HELPERS)
    header_sites = [line for f, line, _ in sites if f == tool.HEADER]
    # a site before and one after each wait, named by the wait's line
    assert waits > 0 and len(header_sites) == 2 * waits
    lines = header.splitlines()
    assert all(tool.WAIT.search(lines[line - 1]) for line in header_sites)
    # the producer's waits are not timed
    assert "g_phase_cycles" not in copies[tool.HEADER][
        slice(*tool._body_span(copies[tool.HEADER], "produce"))]


def test_an_unknown_kernel_raises():
    with pytest.raises(ValueError, match="no definition"):
        tool.instrument(_sources("sdr_fwd"), "sdr_fwd", "no_such_kernel")


def test_the_weight_gradient_kernel_leaves_the_header_alone():
    copies, sites = tool.instrument(_sources("sdr_bwd"), "sdr_bwd",
                                    "sdr_bwd_wgrad_kernel")
    assert tool.HEADER not in copies
    assert sites and all(f == "sdr_bwd.cu" for f, _, _ in sites)
    assert "sdr_bwd_wgrad_kernel" in tool.PER_CALL


@pytest.mark.parametrize("name,kernel", tool.KERNELS[3:])
def test_the_cluster_and_ring_waits_of_the_scan_kernels_are_timed(name,
                                                                  kernel):
    sources = _sources(name)
    source = sources[name + ".cu"]
    copies, sites = tool.instrument(sources, name, kernel)
    waits = len(tool.CLUSTER_WAIT.findall(
        source[slice(*tool._body_span(source, kernel))]))
    cluster_sites = [(line, kind) for f, line, kind in sites
                     if f == name + ".cu" and kind != "block"]
    # a "work" site before and a "cluster_wait" site after each wait
    assert waits >= 3 and len(cluster_sites) == 2 * waits
    assert [kind for _, kind in cluster_sites] == ["work", "cluster_wait"
                                                   ] * waits
    lines = source.splitlines()
    assert all(tool.CLUSTER_WAIT.search(lines[line - 1])
               for line, _ in cluster_sites)
    # the ring's waits for bulk copies, in ring_rows, on both sides
    header = sources[tool.CLUSTER_HEADER]
    ring_sites = [(line, kind) for f, line, kind in sites
                  if f == tool.CLUSTER_HEADER]
    assert [kind for _, kind in ring_sites] == ["work", "ring_wait"]
    assert tool.WAIT.search(header.splitlines()[ring_sites[0][0] - 1])
    assert tool.HEADER not in copies
