"""patch_ms.<kind>: device milliseconds a served step spends in the kernels
launched inside the program's `dit.patch` spans: each DiT and branch call's
patch embed (text projection, patchify and its projection, the time and
ofs embeddings) and the DiT's output head (`norm_final`, `norm_out`,
`proj_out`, unpatchify), tied to the spans by the profiler's correlation
ids. Where the program opens no such span, nothing is read."""

SPAN = "dit.patch"


def read(run):
    if run.trace is None or SPAN not in run.trace.ranges:
        return None
    return sum(o.end - o.start for o in run.trace.launched_in(SPAN)) / 1e3 / run.steps
