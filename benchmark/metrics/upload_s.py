"""The package's upload of the SELL matrix, ending in a synchronize (host
clock)."""


def read(run):
    return run.spans.get("upload")
