"""Host ms a keyswitched op (a relinearize or a rotate) takes to issue the
request's calls into the port (multiply, relinearize, rescale, rotate, add),
over the window."""


def read(t):
    return t.host_ms_per("keyswitches", "multiply", "relinearize", "rescale", "rotate", "add")
