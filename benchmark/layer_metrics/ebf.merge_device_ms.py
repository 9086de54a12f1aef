"""Device time of the operations launched inside the program's
`tasr.ebranchformer.merge` ranges (the depthwise conv over both branches
and its projection), summed over the blocks, ms a decoded batch begun in
the traced part; the runner reduces the trace
(`runners/decode_ebf.py::branch_device_s`)."""


def read(run):
    got = run.rec.get("branch_device_s", {}).get("ebranchformer.merge")
    if run.trace is None or not got:
        return None
    n = len(run.spans.between("predict", run.trace_from, run.trace_to))
    return 1e3 * got / n if n else None
