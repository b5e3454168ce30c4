"""graftlint fixture: contract-drift — one seeded violation.

Emits a ledger event whose name the graftcontract registry does not
declare. The emit uses the real ``observe.emit`` idiom so the rule's
wrapper resolution (not just a name match) is what fires.
"""

from bsseqconsensusreads_tpu_torch.utils import observe


def fx_finish(records):
    observe.emit("fx_phantom_event", {"records": records})  # seeded: contract-drift
