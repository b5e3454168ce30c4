"""deep_rows_pct: the share of the molecular vote's rows that seg_vote's
deep tiles vote — the program's 'vote.deep_rows' over 'vote.deep_rows' +
'vote.packed_rows' (counted per launch from the deep plan on the host
offsets, both summed over the window), in %. None where the program
counts no vote plans or voted no rows."""


def read(w):
    deep = w.counters.get("vote.deep_rows")
    packed = w.counters.get("vote.packed_rows")
    if deep is None or packed is None or deep + packed <= 0:
        return None
    return 100.0 * deep / (deep + packed)
