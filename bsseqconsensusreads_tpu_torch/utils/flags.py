"""The bisulfite flag vocabulary the pipeline dispatches on.

bwameth emits paired-end bisulfite alignments whose strand identity is carried
by the SAM flag. The reference's conversion tool switches on exactly these
values (reference: tools/1.convert_AG_to_CT.py:70,73) and its gap-extension
tool pairs them (reference: tools/2.extend_gap.py:61,123,129):

* 99  (paired, proper, mate-reverse, read1, forward)  — A-strand R1, already C/T space
* 147 (paired, proper, reverse, read2)                — A-strand R2, already C/T space
* 163 (paired, proper, mate-reverse, read2, forward)  — B-strand R2, needs A/G->C/T conversion
* 83  (paired, proper, reverse, read1)                — B-strand R1, needs A/G->C/T conversion
* 0 / 1 — degenerate unpaired cases the reference passes through / converts.

Duplex pairing is by mapped orientation: (99, 163) both map forward and merge
into the duplex R1; (83, 147) both map reverse and merge into the duplex R2.
"""

PASSTHROUGH_FLAGS = frozenset({0, 99, 147})
CONVERT_FLAGS = frozenset({1, 83, 163})
KEEP_FLAGS = PASSTHROUGH_FLAGS | CONVERT_FLAGS

FORWARD_PAIR = (99, 163)   # duplex R1 sources (top-strand window)
REVERSE_PAIR = (83, 147)   # duplex R2 sources
GROUP_ORDER = (99, 163, 83, 147)  # output order inside a duplex group
                                  # (reference: tools/2.extend_gap.py:136)
