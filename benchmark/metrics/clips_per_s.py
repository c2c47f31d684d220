"""clips_per_s: every clip the window completed over the window's host
seconds, from its start to the synchronise after its last step."""


def read(r):
    return r.window.clips / r.window.seconds
