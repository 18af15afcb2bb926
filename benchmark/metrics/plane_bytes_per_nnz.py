"""Bytes of every device tensor the uploaded container holds, each storage
once, per stored entry."""


def read(run):
    if not run.nnz or "plane_bytes" not in run.counters:
        return None
    return run.counters["plane_bytes"] / run.nnz
