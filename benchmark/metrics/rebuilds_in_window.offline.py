"""rebuilds_in_window.offline: the fused plans built (`plans_built`),
pinned staging buffers (re)allocated (`staging_allocs`) and pinned
blocks the result buffers added to the caching host allocator
(`result_allocs`) inside the timing stretch's `separate_many` call:
set-up work paid in the window."""

from benchmark.harness.spans import program_spans, rebuilds


def read(run):
    return rebuilds(program_spans(run))
