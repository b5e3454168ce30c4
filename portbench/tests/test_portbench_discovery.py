"""A later PR adds a configuration, a mix, a metric or a cell as files
and entries alone: the harness finds each by its name."""

import json
import os

from harness import cells


def test_new_config_mix_metric_and_cell_are_found(tmp_path):
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (bench_dir / sub).mkdir(parents=True)
    (bench_dir / "configs" / "new_cfg.json").write_text(json.dumps({"read_len": 99}))
    (bench_dir / "traffic" / "new_mix.json").write_text(json.dumps({"families_per_pass": 7}))
    (bench_dir / "limits" / "new_cfg.new_mix.json").write_text(json.dumps({"records_missing": 0}))
    (bench_dir / "metrics" / "new_metric.py").write_text(
        "def read(w):\n    return 2.0 * w.reads\n")
    bench = {
        "configs": [{"name": "new_cfg", "file": "portbench/configs/new_cfg.json"}],
        "workloads": [{"name": "new_cfg.new_mix", "config": "new_cfg", "traffic": "new_mix",
                       "chips": 1}],
        "end_to_end": [{"name": "setup_s"}, {"name": "only_elsewhere", "workloads": ["x"]}],
        "per_layer": [{"name": "new_metric"}],
    }
    cell = cells.find_cell(bench, "new_cfg.new_mix", root=str(bench_dir))
    assert cell.config == {"read_len": 99}
    assert cell.mix == {"families_per_pass": 7}
    assert cell.limits == {"records_missing": 0}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]

    class W:
        reads = 21

    assert cells.metric_reader("new_metric", root=str(bench_dir))(W()) == 42.0


def test_every_shipped_cell_and_metric_resolves():
    bench = cells.load_json(os.path.join(os.path.dirname(cells.BENCH_DIR), "BENCHMARK.json"))
    for w in bench["workloads"]:
        cell = cells.find_cell(bench, w["name"])
        assert cell.mix["families_per_pass"] > 0 and cell.limits
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_host_rss_gib"}
        assert "window_reads_per_s" in {m["name"] for m in cell.per_layer}
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))
