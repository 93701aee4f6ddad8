"""The loop's wait on the prefetch queue (``Prefetcher.wait_s``) over the
window, in %."""


def read(r):
    return 100.0 * r.result["prefetch_wait_s"] / r.window_s
