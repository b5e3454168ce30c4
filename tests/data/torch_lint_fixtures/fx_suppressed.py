"""graftlint fixture: a correctly suppressed violation — must yield NO
findings, keeping the directory-wide fixture sweep at exactly one
finding per rule."""

import sys


def fx_quiet_report(msg):
    print(msg, file=sys.stderr)  # graftlint: disable=stderr-print -- fixture demonstrating inline suppression
