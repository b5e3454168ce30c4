"""graftswarm finalize: merge per-slice outputs into the single-process
bytes, and refuse to call the run ok until the counters reconcile.

Why the merge is exact (the determinism proof, README "Elastic
execution"):

* slices are CONTIGUOUS base-family ordinal ranges, so concatenating
  the slice emission streams in slice order reproduces the exact
  family order of the single-process emission stream;
* each slice output is coordinate-sorted by the same near-total
  `raw_coordinate_key` (ref, pos, qname, flag) the single-process sort
  uses, and `heapq.merge` is stable, so merging the slice streams in
  slice order breaks residual key ties by emission order — exactly the
  tie-break the single-process stable sort applies;
* consensus record bytes depend only on family content (qnames come
  from the MI), never the sample name or the process that computed
  them;
* the final header is rebuilt from the ORIGINAL input header + sample
  through the same @PG chain `stages.run_duplex` writes, and the final
  BGZF stream is one continuous level-6 writer — the same compressor
  state path as single-process.

Reconciliation (the "counters reconcile" acceptance gate) cross-checks
three independent ledgers before the ok: split counts (records in),
per-slice StageStats sums (what the pipelines saw), and the merged
stream itself (records out + the per-bucket vectors of the bucket
engine's geometry).
"""

from __future__ import annotations

import heapq
import os

from bsseqconsensusreads_tpu_torch.config import FrameworkConfig
from bsseqconsensusreads_tpu_torch.faults import failpoints as _failpoints
from bsseqconsensusreads_tpu_torch.faults import integrity as _integrity
from bsseqconsensusreads_tpu_torch.io.bam import BamHeader, BamReader, BamWriter
from bsseqconsensusreads_tpu_torch.pipeline.bucketemit import (
    BucketPlan,
    blob_bucket_key,
    resolve_buckets,
)
from bsseqconsensusreads_tpu_torch.pipeline.extsort import raw_coordinate_key
from bsseqconsensusreads_tpu_torch.pipeline.stages import sample_name
from bsseqconsensusreads_tpu_torch.utils import observe

from bsseqconsensusreads_tpu_torch.elastic.coordinator import (
    ElasticError,
    slice_name,
)

from bsseqconsensusreads_tpu_torch import __version__

#: StageStats count keys that sum across slices to the single-process
#: value (time/ratio keys like wall_seconds or pad_waste do not).
SUMMABLE_STATS = (
    "records_in",
    "records_seen",
    "records_quarantined",
    "records_repaired",
    "families_quarantined",
    "family_records_quarantined",
    "families",
    "consensus_out",
    "skipped_families",
    "leftover_records",
    "refragmented_families",
    "batches",
    "indel_aligned",
    "indel_dropped",
)


def final_header(input_header: BamHeader, sample: str) -> BamHeader:
    """The exact header chain stages.run_molecular + run_duplex (self
    mode) apply to the original input header."""
    h = input_header.with_pg(
        "bsseqconsensusreads_tpu_torch", __version__, f"molecular sample={sample}"
    )
    h = h.with_pg(
        "bsseqconsensusreads_tpu_torch", __version__, f"duplex sample={sample}"
    )
    return h.with_sort_order("coordinate")


def _sum_stats(manifests: dict[int, dict]) -> dict[str, dict]:
    """Per-stage sums of the summable StageStats counters across all
    slice manifests."""
    out: dict[str, dict] = {}
    for m in manifests.values():
        for stage, stats in (m.get("stats") or {}).items():
            acc = out.setdefault(stage, {k: 0 for k in SUMMABLE_STATS})
            for k in SUMMABLE_STATS:
                acc[k] += int(stats.get(k, 0))
    return out


def reconcile(
    specs: list[dict],
    manifests: dict[int, dict],
    merged_records: int,
    merged_buckets: list[int],
) -> dict:
    """Cross-check split / per-slice / merged ledgers. Returns the
    report; report['ok'] gates the run."""
    stats = _sum_stats(manifests)
    records_split = sum(sl["records"] for sl in specs)
    records_out = sum(int(m.get("records_out", 0)) for m in manifests.values())
    slice_buckets = [0] * len(merged_buckets)
    for m in manifests.values():
        for i, n in enumerate(m.get("buckets") or []):
            if i < len(slice_buckets):
                slice_buckets[i] += int(n)
    molecular = stats.get("molecular", {})
    checks = {
        "slices_complete": len(manifests) == len(specs),
        "records_out_match_merge": records_out == merged_records,
        "buckets_match": slice_buckets == list(merged_buckets),
        # records in == out + quarantined, measured at the ingest stage:
        # every split record was either consumed by the molecular stage
        # or loudly quarantined — none vanished between processes.
        "records_in_match_split": (
            molecular.get("records_in", 0)
            + molecular.get("records_quarantined", 0)
            == records_split
        ),
    }
    return {
        "ok": all(checks.values()),
        "checks": checks,
        "records": merged_records,
        "records_split": records_split,
        "stats": stats,
    }


def finalize(
    cfg: FrameworkConfig,
    bam_path: str,
    outdir: str,
    specs: list[dict],
    manifests: dict[int, dict],
) -> tuple[str, dict]:
    """K-way merge of the committed slice outputs into the final
    coordinate-sorted BAM, then reconcile. Returns (target, report)."""
    missing = [slice_name(sl["sid"]) for sl in specs
               if sl["sid"] not in manifests]
    if missing:
        raise ElasticError(f"cannot finalize: missing slices {missing}")
    sample = sample_name(bam_path)
    target = os.path.join(outdir, f"{sample}_consensus_duplex_unfiltered.bam")
    _failpoints.fire("elastic_merge", slices=len(specs))

    with BamReader(bam_path) as reader:
        header = final_header(reader.header, sample)
    plan = BucketPlan.from_header(header, resolve_buckets(cfg.sort_buckets))
    bucket_counts = [0] * plan.nbuckets
    merged = 0

    readers = []
    streams = []
    try:
        for sl in sorted(specs, key=lambda s: s["sid"]):
            m = manifests[sl["sid"]]
            out = os.path.join(
                outdir, "elastic", "slices", slice_name(sl["sid"]),
                str(m["output"]),
            )
            _integrity.verify_file_crc32(
                out, int(m["crc"]),
                what=f"slice {slice_name(sl['sid'])} output at merge",
            )
            r = BamReader(out, threads=1)
            readers.append(r)
            streams.append(r.raw_records())

        def counted(blobs):
            nonlocal merged
            for blob in blobs:
                bucket_counts[plan.bucket_of(blob_bucket_key(blob))] += 1
                merged += 1
                yield blob

        tmp = target + ".merge.tmp"
        writer = BamWriter(tmp, header, level=6)
        try:
            writer.write_raw_many(
                counted(heapq.merge(*streams, key=raw_coordinate_key))
            )
        finally:
            writer.close()
        os.replace(tmp, target)
    finally:
        for r in readers:
            r.close()

    report = reconcile(specs, manifests, merged, bucket_counts)
    observe.emit(
        "elastic_merged",
        {"records": merged, "slices": len(specs), "ok": report["ok"]},
    )
    return target, report
