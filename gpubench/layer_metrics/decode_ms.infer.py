"""Milliseconds a batch from the decode's first device operation to the
end of the copy of its joints, scores and valid flags to the host (the
harness's ``decode`` and ``to_host`` spans): the decode's stretch of a
batch's latency, its host syncs included."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ends = [end for name, _, end in tr.spans if name == "to_host"]
    starts = sorted(op[3] for op in tr.ops if op[2] == "decode")
    total, prev = 0.0, float("-inf")
    for end in ends:
        first = next((s for s in starts if prev < s <= end), None)
        if first is None:
            return None
        total += end - first
        prev = end
    return total / len(ends) * 1e3 if ends else None
