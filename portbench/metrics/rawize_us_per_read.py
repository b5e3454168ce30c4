"""rawize_us_per_read: the program's 'rawize' span (worker-busy seconds,
summed over threads and both stages) per input read of the window, in
microseconds."""


def read(w):
    s = w.phase_s.get("rawize", 0.0)
    return 1e6 * s / w.reads if s > 0 else None
