"""loader_wait_ms.pretrain (data): mean host wait for the next superbatch
from ``prefetch_to_device`` over the timed window, by the harness's clock
around ``next()`` (span ``loader_wait``)."""


def read(run):
    return run.get("loader_wait_ms")
