"""Set-up time: process start to the first timed operation (imports, the
corpus or traffic, seeded weights, the warm-up and, in a run that builds
or compiles, that too), in seconds."""


def read(r):
    return r.setup_s
