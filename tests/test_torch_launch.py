"""The port's serving launcher against the reference launcher's recipe.

`repro_torch.core.traces` is the port's own copy of `repro.core.traces`;
`repro_torch.launch.serve` builds its requests as `repro.launch.serve`
does (lengths from `generate_trace(--task)`, prompt tokens from one
seeded generator, prompts capped at capacity − 64 − 2, budgets at 64) with
the reference's defaults (16 requests, α 6.0, capacity 256, prefill 32).
The reference's request list is captured from its own `main()`, with its
trace run replaced by a recorder; the port's from its `main()`, with the
engine replaced by a recorder.  With ``--spec-len 3 --draft-arch
qwen2-0.5b-smoke`` the cap leaves room for the window (capacity − 64 − 4)
and the draft's weights come from seed + 1, as in the reference.  With
``--arrivals 0.5`` the live schedule (the iteration each request arrives
at) equals the one the reference launcher hands its `serve()`, and the
port's run on the CPU finishes every request.  ``--fault`` (repeatable),
``--fault-seed`` and ``--deadline`` give the engine the reference
launcher's injector and the requests its deadline, and a real run of both
launchers prints the same ``resilience:`` line.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import traces as port_traces  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402

TASKS = ("general-qa", "creative-writing")


class _EngineRecorder:
    """Stands in for `PapiEngine` in the port's launcher: keeps the
    engine's keyword arguments and the submitted requests, serves none."""
    made: list = []

    def __init__(self, cfg, params, **kw):
        self.kw, self.requests = kw, []
        self.iteration, self.stats, self.kv = 0, [], None
        self.preemptions = self.degraded_steps = 0
        self.faults = kw.get("faults")
        self.scheduler = type("Sched", (), {"num_reschedules": 0})()
        _EngineRecorder.made.append(self)

    def sanitize_report(self):
        return None

    def submit(self, req):
        self.requests.append(req)

    def run(self, max_iterations):
        return []

    def serve(self, arrivals, max_iterations):
        self.schedule = [[(r.req_id, r.prompt, r.max_new_tokens) for r in tick]
                         for tick in arrivals]
        return iter(())


def _port_launch(monkeypatch, *argv):
    """(engine keyword arguments, [(prompt, budget)]) of one launcher run."""
    _EngineRecorder.made = []
    monkeypatch.setattr(serve_cli, "PapiEngine", _EngineRecorder)
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu", *argv])
    eng, = _EngineRecorder.made
    return eng.kw, [(r.prompt, r.max_new_tokens) for r in eng.requests]


def _port_schedule(monkeypatch, *argv):
    _EngineRecorder.made = []
    monkeypatch.setattr(serve_cli, "PapiEngine", _EngineRecorder)
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu", *argv])
    eng, = _EngineRecorder.made
    return eng.schedule


def _reference_schedule(monkeypatch, *argv):
    """The arrival schedule `repro.launch.serve.main` hands its engine's
    `serve()` under ``--arrivals``: its trace run gets an engine stand-in
    that records the schedule and serves nothing."""
    ref = pytest.importorskip("repro.launch.serve")
    got = []
    run_trace = ref._run_trace

    class Recorder:
        def serve(self, sched, max_iterations):
            got.extend([(r.req_id, list(r.prompt), r.max_new_tokens)
                        for r in tick] for tick in sched)
            return iter(())

    monkeypatch.setattr(ref, "_run_trace", lambda args, eng, reqs, rng:
                        run_trace(args, Recorder(), reqs, rng))
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-0.5b-smoke",
                                      *argv])
    ref.main()
    return got


def _reference_requests(monkeypatch, *argv):
    """[(prompt, budget)] that `repro.launch.serve.main` builds."""
    ref = pytest.importorskip("repro.launch.serve")
    got = []

    def record(args, eng, reqs, rng):
        got.extend((list(r.prompt), r.max_new_tokens) for r in reqs)
        return []

    monkeypatch.setattr(ref, "_run_trace", record)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-0.5b-smoke",
                                      *argv])
    ref.main()
    return got


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("task", TASKS)
def test_generate_trace_matches_reference(task, seed):
    from repro.core import traces as ref_traces
    want = [dataclasses.astuple(r)
            for r in ref_traces.generate_trace(task, 40, seed)]
    got = [dataclasses.astuple(r)
           for r in port_traces.generate_trace(task, 40, seed)]
    assert got == want
    assert port_traces._PROFILES == ref_traces._PROFILES


@pytest.mark.parametrize("task,requests,seed", [("general-qa", 16, 0),
                                                ("creative-writing", 12, 5)])
def test_launcher_requests_match_reference_recipe(monkeypatch, task, requests,
                                                  seed):
    argv = ["--task", task, "--requests", str(requests), "--seed", str(seed)]
    want = _reference_requests(monkeypatch, *argv)
    _, got = _port_launch(monkeypatch, *argv)
    assert len(got) == requests and got == want


def test_launcher_defaults_are_the_reference_defaults(monkeypatch):
    kw, got = _port_launch(monkeypatch)
    assert (kw["cache_capacity"], kw["prefill_len"], kw["alpha"]) == (
        256, 32, 6.0)
    assert got == _reference_requests(monkeypatch)
    assert len(got) == 16
    assert max(len(p) for p, _ in got) <= 256 - 64 - 2
    assert all(1 <= b <= 64 for _, b in got)
    vocab = get_config("qwen2-0.5b-smoke").vocab_size
    assert all(3 <= t < vocab for p, _ in got for t in p)


def test_launcher_max_prompt_override_caps_prompts(monkeypatch):
    _, capped = _port_launch(monkeypatch, "--max-prompt", "20")
    _, full = _port_launch(monkeypatch)
    assert max(len(p) for p, _ in capped) == 20
    # prompts longer than the cap are cut to it, shorter ones keep their
    # length, and the budgets do not move
    lens = [min(len(p), 20) for p, _ in full]
    assert [len(p) for p, _ in capped] == lens
    assert [b for _, b in capped] == [b for _, b in full]


def test_launcher_capacity_override_moves_the_default_cap(monkeypatch):
    kw, got = _port_launch(monkeypatch, "--capacity", "128")
    assert kw["cache_capacity"] == 128
    assert max(len(p) for p, _ in got) <= serve_cli.default_max_prompt(128)
    assert serve_cli.default_max_prompt(256) == 256 - 64 - 2


def test_make_requests_is_deterministic_per_seed():
    a = serve_cli.make_requests("general-qa", 8, 500, 3, 100)
    b = serve_cli.make_requests("general-qa", 8, 500, 3, 100)
    c = serve_cli.make_requests("general-qa", 8, 500, 4, 100)
    key = [(r.prompt, r.max_new_tokens) for r in a]
    assert key == [(r.prompt, r.max_new_tokens) for r in b]
    assert key != [(r.prompt, r.max_new_tokens) for r in c]
    assert np.all([r.req_id == i for i, r in enumerate(a)])


def test_launcher_default_run_serves_the_reference_trace(capsys):
    """No flags but the model and the CPU: the 16 general-qa requests at
    capacity 256, prefill 32, alpha 6 are served to the end."""
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "completed 16 requests" in out and "fc_path" in out


SPEC = ("--spec-len", "3", "--draft-arch", "qwen2-0.5b-smoke")


def test_launcher_spec_requests_match_reference_recipe(monkeypatch):
    """With a speculative window of 3 the prompt cap leaves room for it
    (capacity - 64 - 3 - 1), as the reference launcher's does; the engine
    gets the window and a draft of the named arch."""
    want = _reference_requests(monkeypatch, *SPEC)
    kw, got = _port_launch(monkeypatch, *SPEC)
    assert got == want and len(got) == 16
    assert max(len(p) for p, _ in got) <= serve_cli.default_max_prompt(256, 3)
    assert serve_cli.default_max_prompt(256, 3) == 256 - 64 - 3 - 1
    assert kw["spec_len"] == 3
    dcfg, dparams = kw["draft"]
    assert dcfg == get_config("qwen2-0.5b-smoke")
    # the draft's weights come from seed + 1
    from repro_torch.models import init_params
    want_w = init_params(dcfg, torch.Generator().manual_seed(1))
    assert torch.equal(dparams["embed"]["w"], want_w["embed"]["w"])


def test_launcher_serves_speculatively(capsys):
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
                    "--requests", "4", *SPEC])
    out = capsys.readouterr().out
    assert "completed 4 requests" in out
    assert "mean accepted per window" in out


@pytest.mark.parametrize("argv", [("--arrivals", "0.5"),
                                  ("--arrivals", "2", "--seed", "3",
                                   "--requests", "12")])
def test_launcher_arrival_schedule_matches_reference(monkeypatch, argv):
    want = _reference_schedule(monkeypatch, *argv)
    got = _port_schedule(monkeypatch, *argv)
    assert got == want
    assert sum(len(t) for t in got) == int(dict(zip(argv, argv[1:])).get(
        "--requests", 16))
    # the schedule's requests are the offline run's, in the same order
    ids = [i for tick in got for i, _, _ in tick]
    assert ids == sorted(ids)


def test_arrival_schedule_of_no_requests_is_one_quiet_tick():
    assert serve_cli.arrival_schedule([], 0.5,
                                      np.random.default_rng(0)) == [[]]


def test_launcher_arrivals_serves_every_request(capsys):
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
                    "--arrivals", "0.5", "--requests", "8"])
    out = capsys.readouterr().out
    assert out.count("queue ") == 8 and "ttft" in out
    assert "completed 8 requests" in out and "'length': 8" in out
    assert "ttft_iters        p50" in out and "tpot_s" in out


FAULTS = ("--fault", "nan:0.3", "--fault", "kernel:0.2", "--fault",
          "admit:0.3", "--fault-seed", "3")


def _reference_engine_kw(monkeypatch, *argv):
    """(engine keyword arguments, [(prompt, budget, deadline)]) that
    `repro.launch.serve.main` builds: its engine is replaced by the
    recorder, its trace run by one that keeps the requests."""
    ref = pytest.importorskip("repro.launch.serve")
    import repro.serving
    got = []

    def record(args, eng, reqs, rng):
        got.extend((list(r.prompt), r.max_new_tokens, r.deadline_s)
                   for r in reqs)
        return []

    _EngineRecorder.made = []
    monkeypatch.setattr(repro.serving, "PapiEngine", _EngineRecorder)
    monkeypatch.setattr(ref, "_run_trace", record)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-0.5b-smoke",
                                      *argv])
    ref.main()
    eng, = _EngineRecorder.made
    return eng.kw, got


@pytest.mark.parametrize("argv", [FAULTS + ("--deadline", "2.5"),
                                  ("--fault", "latency:0.5", "--fault",
                                   "crash:0.01"),
                                  ()])
def test_launcher_fault_flags_match_reference(monkeypatch, argv):
    """The port's engine gets the reference launcher's fault injector (or
    none without ``--fault``), and its requests the same deadline."""
    want_kw, want = _reference_engine_kw(monkeypatch, *argv)
    _EngineRecorder.made = []
    monkeypatch.setattr(serve_cli, "PapiEngine", _EngineRecorder)
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu", *argv])
    eng, = _EngineRecorder.made
    got = [(r.prompt, r.max_new_tokens, r.deadline_s) for r in eng.requests]
    assert got == want
    w, g = want_kw["faults"], eng.kw["faults"]
    if w is None:
        assert g is None
    else:
        fields = [f.name for f in dataclasses.fields(w)]
        assert {f: getattr(g, f) for f in fields} == {
            f: getattr(w, f) for f in fields}


def test_launcher_resilience_line_matches_reference(monkeypatch, capsys):
    """A real run of both launchers on the smoke twin under the same fault
    flags: the same degraded steps and faults fired."""
    ref = pytest.importorskip("repro.launch.serve")
    argv = ("--requests", "3") + FAULTS
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-0.5b-smoke",
                                      *argv])
    ref.main()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("resilience:")]
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    got = [ln for ln in out.splitlines() if ln.startswith("resilience:")]
    assert got == want and len(got) == 1
    assert "degraded steps" in got[0] and "0 degraded" not in got[0]
    assert "completed 3 requests" in out


def test_launcher_crash_fault_exits_1(capsys):
    with pytest.raises(SystemExit) as err:
        serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
                        "--requests", "2", "--fault", "crash:0.2"])
    assert err.value.code == 1
    assert "engine crashed (injected) at iteration" in capsys.readouterr().out


# ------------------------------------------- durability and observability

def _finished(path) -> dict:
    from repro_torch.serving import recover
    state = recover(path)
    assert not state.requests
    return {rid: f.tokens for rid, f in state.finished.items()}


def test_launcher_journal_resume_completes_a_crashed_run(tmp_path, capsys):
    """``--journal`` + a crash fault ends the run with exit code 1 and the
    recovery hint; ``--journal X --resume X`` serves the unfinished
    requests to the end.  The journal then holds every request once, with
    the uncrashed run's streams."""
    base = ["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
            "--requests", "4"]
    clean = tmp_path / "clean.wal"
    serve_cli.main(base + ["--journal", str(clean)])
    want = _finished(clean)
    assert sorted(want) == [0, 1, 2, 3]
    wal = tmp_path / "crash.wal"
    capsys.readouterr()
    with pytest.raises(SystemExit) as err:
        serve_cli.main(base + ["--journal", str(wal), "--fault", "crash:0.2",
                               "--fault-seed", "1"])
    assert err.value.code == 1
    out = capsys.readouterr().out
    assert f"recover with --resume {wal}" in out
    serve_cli.main(base + ["--journal", str(wal), "--resume", str(wal)])
    out = capsys.readouterr().out
    resumed = int(out.split("resumed ")[1].split()[0])
    assert resumed >= 1 and f"completed {resumed} requests" in out
    assert _finished(wal) == want


def test_launcher_trace_metrics_and_sanitize(tmp_path, capsys):
    """``--trace`` writes a trace `tools/trace_report.py` validates (chrome
    and jsonl), ``--metrics-out`` the Prometheus snapshot, ``--sanitize``
    prints the report at one transfer per steady iteration."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import trace_report
    for fmt in ("chrome", "jsonl"):
        trace, prom = tmp_path / f"t.{fmt}", tmp_path / f"m.{fmt}.prom"
        serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
                        "--requests", "3", "--trace", str(trace),
                        "--trace-format", fmt, "--metrics-out", str(prom),
                        "--sanitize"])
        out = capsys.readouterr().out
        assert trace_report.main([str(trace), "--validate"]) == 0
        assert "papi_engine_iterations_total" in prom.read_text()
        assert f"-> {trace}" in out and "program keys" in out
        line, = [ln for ln in out.splitlines() if ln.startswith("sanitize:")]
        assert "at 1.00 transfers/iter (budget 1)" in line
    capsys.readouterr()
    prom = tmp_path / "only.prom"
    serve_cli.main(["--arch", "qwen2-0.5b-smoke", "--device", "cpu",
                    "--requests", "2", "--metrics-out", str(prom)])
    assert "telemetry:" in capsys.readouterr().out and prom.exists()


@pytest.mark.parametrize("argv", [("--sanitize", "--journal", "j.wal",
                                   "--trace", "t.json"),
                                  ("--metrics-out", "m.prom"), ()])
def test_launcher_engine_flags_match_reference(monkeypatch, tmp_path,
                                               argv):
    """The tracer, sanitize and journal arguments the port's launcher
    hands its engine are the reference launcher's.  The reference's report
    is skipped: its `_report` names `write_trace` and `export_prometheus`,
    which only its `main()` imports, so it raises NameError under
    ``--trace`` / ``--metrics-out`` (ROADMAP queue 3)."""
    ref = pytest.importorskip("repro.launch.serve")
    monkeypatch.setattr(ref, "_report", lambda *a: None)
    monkeypatch.chdir(tmp_path)
    want, _ = _reference_engine_kw(monkeypatch, *argv)
    got, _ = _port_launch(monkeypatch, *argv)
    for key in ("sanitize", "journal"):
        assert got[key] == want[key]
    assert ((got["tracer"] is None) == (want["tracer"] is None))
