"""graftlint fixture: stderr-print — one seeded violation."""

import sys


def fx_report(msg):
    print(msg, file=sys.stderr)  # seeded: stderr-print
