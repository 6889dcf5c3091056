"""The port's fault injector (`repro_torch.serving.faults`) against the
reference's (`repro.serving.faults`): every case of `tests/test_faults.py`
run on both, with the same decisions, the same counts and the same
`parse_fault_specs` errors for the same seeds, windows and specs."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.serving import faults as ref  # noqa: E402
from repro_torch.serving import faults as port  # noqa: E402

FIELDS = [f.name for f in dataclasses.fields(ref.FaultInjector)]


def _pair(**kw):
    return ref.FaultInjector(**kw), port.FaultInjector(**kw)


def _consults(inj, steps):
    """Every consult of every step, twice (a repeated consult replays)."""
    return [(inj.admission_blocked(i), inj.logits_fault(i), inj.step_delay(i),
             inj.crash_now(i), inj.logits_fault(i)) for i in steps]


def test_constants_and_fields_match_reference():
    assert port.KINDS == ref.KINDS
    assert (port.FAULT_NONE, port.FAULT_NAN, port.FAULT_INF) == (
        ref.FAULT_NONE, ref.FAULT_NAN, ref.FAULT_INF)
    assert [f.name for f in dataclasses.fields(port.FaultInjector)] == FIELDS
    assert ({f.name: f.default for f in dataclasses.fields(port.FaultInjector)}
            == {f.name: f.default
                for f in dataclasses.fields(ref.FaultInjector)})


@pytest.mark.parametrize("seed", [0, 3, 42, 6174])
def test_injector_pure_function_of_seed_and_step(seed):
    """Same (seed, iteration): the same decision on every consult, in both
    packages, and the same counts after."""
    kw = dict(seed=seed, admit_p=0.5, nan_p=0.3, kernel_p=0.3, latency_p=0.5,
              crash_p=0.1)
    r, p = _pair(**kw)
    got = _consults(p, range(200))
    assert got == _consults(r, range(200))
    assert p.counts == r.counts
    again = port.FaultInjector(**kw)
    assert _consults(again, range(200)) == got
    hits = [port.FaultInjector(seed=seed, nan_p=0.3).logits_fault(s)
            == port.FAULT_NAN for s in range(100)]
    assert any(hits) and not all(hits)


def test_injector_different_seeds_differ():
    sched = [port.FaultInjector(seed=s, nan_p=0.5).logits_fault(i)
             for s in (0, 1) for i in range(50)]
    assert sched[:50] != sched[50:]
    assert sched == [ref.FaultInjector(seed=s, nan_p=0.5).logits_fault(i)
                     for s in (0, 1) for i in range(50)]


@pytest.mark.parametrize("start,stop", [(10, 20), (2, 4), (5, None)])
def test_injector_window_respected(start, stop):
    r, p = _pair(seed=7, admit_p=1.0, nan_p=1.0, latency_p=1.0,
                 start=start, stop=stop)
    for step in range(30):
        inside = step >= start and (stop is None or step < stop)
        assert p.admission_blocked(step) == inside
        assert (p.logits_fault(step) != port.FAULT_NONE) == inside
        assert (p.step_delay(step) > 0) == inside
        r.admission_blocked(step), r.logits_fault(step), r.step_delay(step)
    n = (stop or 30) - start
    assert p.counts["admit"] == p.counts["nan"] == n
    assert p.counts == r.counts


def test_nan_wins_over_kernel():
    inj = port.FaultInjector(seed=0, nan_p=1.0, kernel_p=1.0)
    assert inj.logits_fault(3) == port.FAULT_NAN
    only_kernel = port.FaultInjector(seed=0, kernel_p=1.0)
    assert only_kernel.logits_fault(3) == port.FAULT_INF
    assert inj.counts == {"admit": 0, "nan": 1, "kernel": 0, "latency": 0,
                          "crash": 0}


@pytest.mark.parametrize("specs,kw", [
    (["nan:0.2", "admit"], dict(seed=5, latency_s=0.01)),
    (["kernel:0.5", "latency:0.25", "crash:0.05"], dict(seed=3)),
    (["admit:0", "nan:1"], {}),
])
def test_parse_specs_builds_the_reference_injector(specs, kw):
    want = ref.parse_fault_specs(specs, **kw)
    got = port.parse_fault_specs(specs, **kw)
    assert {f: getattr(got, f) for f in FIELDS} == {
        f: getattr(want, f) for f in FIELDS}
    assert port.parse_fault_specs([]) is None


def test_parse_specs_defaults():
    inj = port.parse_fault_specs(["nan:0.2", "admit"], seed=5,
                                 latency_s=0.01)
    assert inj.seed == 5
    assert inj.nan_p == pytest.approx(0.2)
    assert inj.admit_p == 1.0
    assert inj.kernel_p == inj.latency_p == 0.0


@pytest.mark.parametrize("spec,match", [
    ("gamma-ray", "unknown fault kind"),
    ("nan:1.5", r"outside \[0, 1\]"),
    ("admit:-0.1", r"outside \[0, 1\]"),
    ("kernel:2", r"outside \[0, 1\]"),
    ("nan:often", "not a number"),
])
def test_parse_specs_errors_match_reference(spec, match):
    with pytest.raises(ValueError, match=match) as got:
        port.parse_fault_specs([spec])
    with pytest.raises(ValueError) as want:
        ref.parse_fault_specs([spec])
    assert str(got.value) == str(want.value)
