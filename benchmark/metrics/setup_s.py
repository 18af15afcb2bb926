"""Set-up: from the process's start to the first request of the window
(host clock): import, generation, conversion, upload, banks, warm-up and,
on a checkout's first run, the kernel builds."""


def read(run):
    return run.spans.get("setup")
