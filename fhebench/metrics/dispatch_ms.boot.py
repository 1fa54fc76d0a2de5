"""Host ms a bootstrap spends in Python issuing regular_bootstrap and all
below it (no synchronization inside the span), over the window."""


def read(t):
    return t.host_ms_per("bootstraps", "regular_bootstrap")
