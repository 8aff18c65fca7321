"""The card's delivery term in ``select_delivery`` on the CPU: where rows
are wider than ``H100_CONTESTED_WIDTH_BYTES`` the pick is measured (one
delivery pair on each lowering), elsewhere it is the fixed term.  No card
here, so the ``cuda`` lowering is forced and the timer injected (the
module's ``time_in_turns`` replaced): a contested point takes the
lowering with the smaller injected time, but keeps the fused kernel
where ``xla`` leads by no more than ``DELIVERY_MEASURE_MARGIN``, the
``Engine`` measures once per structure and message width, and an
uncontested point never calls the timer.  That ranks that time differently still agree on one pick is
``tests/test_torch_distributed.py::test_ranks_agree_on_a_measured_delivery_pick``."""
import pytest
import torch

from repro_torch.algorithms import AlgorithmSpec
from repro_torch.core import Engine, Program
from repro_torch.core import executor
from repro_torch.data import make_dataset


@pytest.fixture
def card_lowering(monkeypatch):
    monkeypatch.setattr(executor, "select_lowering", lambda device: "cuda")


@pytest.fixture(scope="module")
def hgs():
    return (make_dataset("dblp", 0.002, seed=0, device="cpu"),
            make_dataset("dblp", 0.003, seed=0, device="cpu"))


def _spec(hg, d):
    prog = Program(procedure=None, combiner="sum")
    return AlgorithmSpec(hg0=hg, initial_msg=torch.zeros(d), v_program=prog,
                         he_program=prog, max_iters=1, extract=lambda o: o)


class Timer:
    """Returns fixed times and counts its calls; runs each pair once, so
    that both lowerings are known to run on the structure."""

    def __init__(self, xla_ms, fused_ms):
        self.times = (xla_ms, fused_ms)
        self.calls = 0

    def __call__(self, xla_pair, fused_pair, device):
        assert device == torch.device("cpu")
        xla_pair()
        fused_pair()
        self.calls += 1
        return self.times


def _refuse(*args):
    raise AssertionError("an uncontested point called the timer")


@pytest.fixture
def use_timer(monkeypatch):
    """Installs a timer in place of ``executor.time_in_turns``."""
    return lambda timer: monkeypatch.setattr(executor, "time_in_turns",
                                             timer)


@pytest.mark.parametrize("times,pick", [((1.0, 2.0), "xla"),
                                        ((2.0, 1.0), "pallas_fused"),
                                        ((0.2285, 0.2596), "xla")])
def test_contested_point_takes_the_faster_measured_lowering(
        card_lowering, use_timer, hgs, times, pick):
    hg = hgs[0]
    timer = Timer(*times)
    use_timer(timer)
    eng = Engine(device="cpu")
    resolved, _, decision = eng.resolve(_spec(hg, 64))
    assert resolved.delivery == pick
    why = decision["delivery"]
    assert why["lowering"] == "cuda"
    assert why["message_width_bytes"] == 256.0
    assert why["measured_ms"] == {"xla": times[0], "pallas_fused": times[1]}
    assert "contested" in why["reason"]
    assert timer.calls == 1
    # The module-level function takes an injected measure too.
    got, why = executor.select_delivery(_spec(hg, 64), hg,
                                        measure=lambda s, h: times)
    assert got == pick and why["measured_ms"]["xla"] == times[0]


@pytest.mark.parametrize("times,pick", [((0.95, 1.0), "pallas_fused"),
                                        ((1.0, 1.0), "pallas_fused"),
                                        ((1.0, 1.1), "pallas_fused"),
                                        ((0.9, 1.0), "xla")])
def test_a_small_lead_of_xla_keeps_the_kernel(card_lowering, use_timer, hgs,
                                              times, pick):
    """``xla`` is taken only where it leads by more than the margin (10%):
    5% or a tie keeps the kernel, 11% does not."""
    assert executor.DELIVERY_MEASURE_MARGIN == 0.10
    use_timer(Timer(*times))
    resolved, _, decision = Engine(device="cpu").resolve(_spec(hgs[0], 64))
    assert resolved.delivery == pick
    assert decision["delivery"]["measured_ms"] == {
        "xla": times[0], "pallas_fused": times[1]}
    assert "10%" in decision["delivery"]["reason"]
    assert executor.measured_pick(*times) == pick


def test_measurement_runs_once_per_structure_and_width(card_lowering,
                                                       use_timer, hgs):
    timer = Timer(1.0, 0.5)
    use_timer(timer)
    eng = Engine(device="cpu")
    a, b = hgs
    for _ in range(3):
        assert eng.resolve(_spec(a, 64))[0].delivery == "pallas_fused"
    eng.explain(_spec(a, 64))
    assert timer.calls == 1
    eng.resolve(_spec(a, 32))           # 128-byte rows: a new width
    assert timer.calls == 2
    eng.resolve(_spec(b, 64))           # a new structure
    assert timer.calls == 3
    eng.resolve(_spec(b, 32))
    eng.resolve(_spec(a, 64))
    eng.resolve(_spec(b, 64))
    assert timer.calls == 4
    # An Engine of its own measures for itself.
    Engine(device="cpu").resolve(_spec(a, 64))
    assert timer.calls == 5


@pytest.mark.parametrize("d", [1, 2, 8, 16])
def test_uncontested_point_never_calls_the_timer(card_lowering, use_timer,
                                                 hgs, d):
    hg = hgs[0]
    use_timer(_refuse)
    eng = Engine(device="cpu")
    resolved, _, decision = eng.resolve(_spec(hg, d))
    why = decision["delivery"]
    assert resolved.delivery == "pallas_fused"   # 5,660 incidences
    assert "measured_ms" not in why
    assert why["min_nnz"] == executor.H100_FUSED_MIN_NNZ
    eng.explain(_spec(hg, d))
    got, why = executor.select_delivery(_spec(hg, d), hg, measure=_refuse)
    assert got == "pallas_fused" and "measured_ms" not in why


def test_below_the_floor_stays_reference_unless_contested(card_lowering):
    hg = make_dataset("dblp", 0.001, seed=0, device="cpu")
    assert hg.nnz < executor.H100_FUSED_MIN_NNZ
    got, why = executor.select_delivery(_spec(hg, 16), hg, measure=_refuse)
    assert got == "xla" and "smallest measured" in why["reason"]
    got, why = executor.select_delivery(_spec(hg, 64), hg,
                                        measure=lambda s, h: (2.0, 1.0))
    assert got == "pallas_fused" and "measured_ms" in why
    # A contested point with nothing to measure it is refused.
    with pytest.raises(ValueError, match="contested"):
        executor.select_delivery(_spec(hg, 64), hg)


def test_cpu_lowering_is_the_ell_model(use_timer, hgs):
    use_timer(_refuse)
    eng = Engine(device="cpu")
    for d in (1, 16, 64):
        why = eng.resolve(_spec(hgs[0], d))[2]["delivery"]
        assert why["lowering"] == "ell" and "measured_ms" not in why
