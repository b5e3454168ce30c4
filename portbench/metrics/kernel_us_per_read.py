"""kernel_us_per_read: the program's 'kernel' span — a batch's dispatch
on its worker: the wire's C pack (its part 'kernel.pack'), the H2D copies
('kernel.h2d') and the launches (what is left); worker-busy seconds, both
stages — per input read of the window, in microseconds. A traced run
prints both parts among its phase seconds."""


def read(w):
    s = w.phase_s.get("kernel", 0.0)
    return 1e6 * s / w.reads if s > 0 else None
