"""device_idle_pct: 100 x (1 - the union of the device's event intervals
in the traced window over the window's length)."""


def read(w):
    if w.device is None or w.device["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - w.device["busy_s"] / w.device["window_s"])
