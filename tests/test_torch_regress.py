"""`repro_torch.obs.regress` against `repro.obs.regress`, on the same
results directories: the headline and trend specs, `make_record` (less
its timestamp and git sha), `compare`'s violations and notes, and
`pin_baselines`, equal; the history file round-trips.

The directories are built from `benchmarks/baselines.json`'s own keys:
each pinned metric is written at its spec's path in its results file.
Seeded regressions move one metric of each direction past its band."""

import json
import os

import pytest

from repro.obs import regress as J
from repro_torch.obs import regress as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINES = os.path.join(ROOT, "benchmarks", "baselines.json")


def _write_results(directory, metrics, trend=None):
    """Results files holding `metrics` (and `trend`) at their specs'
    paths."""
    files = {}
    specs = [(k, f, p) for k, f, p, *_ in J.HEADLINE_SPECS] + list(
        J.TREND_SPECS)
    values = dict(metrics, **(trend or {}))
    for key, fname, path in specs:
        if key not in values:
            continue
        node = files.setdefault(fname, {})
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = values[key]
    os.makedirs(directory, exist_ok=True)
    for fname, blob in files.items():
        with open(os.path.join(directory, fname), "w") as fh:
            json.dump(blob, fh)
    return str(directory)


@pytest.fixture(scope="module")
def pinned():
    return J.load_baselines(BASELINES)


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("ts_utc", "git_sha", "pinned_at")}


def test_specs_are_the_references():
    assert T.HEADLINE_SPECS == J.HEADLINE_SPECS
    assert T.TREND_SPECS == J.TREND_SPECS
    assert T.tolerance_spec() == J.tolerance_spec()
    assert T.SCHEMA_VERSION == J.SCHEMA_VERSION


def test_make_record_equals_the_reference(tmp_path, pinned):
    trend = {"serve.paged.tok_per_s": 123.5, "serve.paged.wall_s": 2.25}
    d = _write_results(tmp_path / "r", pinned["metrics"], trend)
    got = T.make_record(d, extra={"note": "x"})
    want = J.make_record(d, extra={"note": "x"})
    assert _strip(got) == _strip(want)
    assert got["metrics"] == pinned["metrics"]
    assert got["trend"] == trend
    assert set(got) >= {"ts_utc", "git_sha", "config_hash"}


def test_clean_run_has_no_violations(tmp_path, pinned):
    d = _write_results(tmp_path / "r", pinned["metrics"])
    for mod in (T, J):
        v, notes = mod.compare(mod.collect_headline(d), pinned["metrics"],
                               pinned["tolerances"])
        assert v == [] and notes == []


SEEDED = {
    # exact: any change
    "serve.paged.ticks": 1.0,
    # high_bad: past max(rel_tol * |base|, abs_tol) upward
    "serve.paged.streamed_bytes_total": 1.02,
    # low_bad: downward
    "prefix.prefill_token_reduction": -0.03,
}


@pytest.mark.parametrize("metric", sorted(SEEDED))
def test_seeded_regressions_equal_the_reference(tmp_path, pinned, metric):
    metrics = dict(pinned["metrics"])
    delta = SEEDED[metric]
    metrics[metric] = (metrics[metric] * delta if metric.endswith("_total")
                       else metrics[metric] + delta)
    # an improvement in a directional metric is a note, not a violation
    metrics["kernel.gather_reduction"] += 0.5
    del metrics["serve.dense.decode_tokens"]           # stopped reporting
    d = _write_results(tmp_path / "r", metrics)
    out = []
    for mod in (T, J):
        v, notes = mod.compare(mod.collect_headline(d), pinned["metrics"],
                               pinned["tolerances"])
        out.append(([str(x) for x in v], notes))
    assert out[0] == out[1]
    violated = {s.split(":")[0] for s in out[0][0]}
    assert violated == {metric, "serve.dense.decode_tokens"}
    assert any("kernel.gather_reduction" in n for n in out[0][1])


def test_both_direction_and_default_tolerance(tmp_path):
    base = {"a": 1.0, "b": 10.0}
    cur = {"a": 0.5, "b": 10.6, "c": 3.0}
    tol = {"a": {"direction": "both", "rel_tol": 0.1, "abs_tol": 0.0}}
    got = T.compare(cur, base, tol)
    want = J.compare(cur, base, tol)
    assert [str(v) for v in got[0]] == [str(v) for v in want[0]]
    assert got[1] == want[1]
    assert {v.metric for v in got[0]} == {"a", "b"}


def test_pin_baselines_equal_the_reference(tmp_path, pinned):
    d = _write_results(tmp_path / "r", pinned["metrics"])
    got = T.pin_baselines(str(tmp_path / "t.json"), d)
    want = J.pin_baselines(str(tmp_path / "j.json"), d)
    assert _strip(got) == _strip(want)
    assert _strip(T.load_baselines(str(tmp_path / "t.json"))) == \
        _strip(pinned)


def test_history_round_trip(tmp_path, pinned):
    d = _write_results(tmp_path / "r", pinned["metrics"])
    hist = str(tmp_path / "h" / "history.jsonl")
    assert T.read_history(hist) == []
    for _ in range(2):
        T.append_history(hist, T.make_record(d))
    assert T.read_history(hist) == J.read_history(hist)
    assert len(T.read_history(hist)) == 2


def test_findings_counts_read_from_the_analysis_json(tmp_path):
    """The port's analysis CLI writes the counts the `analysis.findings_*`
    specs read (under the reference's file name in a results dir)."""
    from repro_torch.analysis.__main__ import main

    d = tmp_path / "r"
    assert main(["--root", ROOT, "--layers", "repo", "--json",
                 str(d / "analysis_findings.json")]) == 0
    rec = T.make_record(str(d))
    assert rec["metrics"] == {"analysis.findings_total": 0.0,
                              "analysis.findings_new": 0.0}
