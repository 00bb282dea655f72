"""The check must fail what it is there to catch. At a small size on the
CPU, with the limits of the configurations: the sound program passes; the
fp8 control (the reference one precision step below the configurations'
bf16, in the program's place) fails; and so does a run of the harness
whose timed path is broken underneath: a step that hands its state back
unchanged, half of the batch left out (the rest's mean in its place), or
the flow altered where the network produces it; and, for PCFA, an L-BFGS
iteration whose history push or step goes wrong: the step stored in the
ring's next slot, the gradient difference stored doubled, an iterate that
never moves, a first step twice its length, or a segment cut short after
its first iteration. (One chip: there is no exchange between chips to
leave out.)"""

from __future__ import annotations

import pytest
import torch

import control
import harness
from conftest import configured, tiny_cell

CELLS = ["raft-pcfa-kitti-b2", "pwcnet-pcfa-kitti-b1", "raft-ifgsm-kitti-b2"]


def _run(cell, seed=21):
    return harness.run(cell, seed, 0.0, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_passes(name, monkeypatch):
    out = _run(configured(tiny_cell(name), monkeypatch))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_fails(name):
    cell = tiny_cell(name)
    numbers = control.readings(cell, 21, torch.device("cpu"))
    limits = cell.config["limits"][cell.traffic["attack"]]
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


def _unchanged_step(monkeypatch, attack):
    if attack == "pcfa":
        from pcfa_tpu_torch.attack import pcfa

        real = pcfa.pcfa_outer_step

        def step(*a, **k):
            _, metrics, flow = real(*a, **k)
            return a[5], metrics, flow

        monkeypatch.setattr(pcfa, "pcfa_outer_step", step)
    else:
        from pcfa_tpu_torch.attack import fgsm

        real = fgsm.fgsm_step

        def step(*a, **k):
            _, rest = real(*a, **k)
            return a[5], rest

        monkeypatch.setattr(fgsm, "fgsm_step", step)


def _half_batch(monkeypatch, attack):
    from pcfa_tpu_torch.attack import fgsm, pcfa

    def per_pair(fn, *tensors):
        half = max(1, tensors[0].shape[0] // 2)
        kept = torch.stack([fn(*(t[b] for t in tensors))
                            for b in range(half)])
        rest = kept.mean().expand(tensors[0].shape[0] - half)
        return torch.cat([kept, rest])

    monkeypatch.setattr(pcfa, "_per_pair", per_pair)
    monkeypatch.setattr(fgsm, "_per_pair", per_pair)


def _altered_flow(monkeypatch, attack):
    from pcfa_tpu_torch import runtime

    real = runtime.make_flow_fn

    def make(*a, **k):
        padder, fn = real(*a, **k)

        def altered(x1, x2):
            out = fn(x1, x2)
            shift = torch.zeros_like(out)
            shift[0, ..., 0] = 0.5
            return out + shift

        return padder, altered

    monkeypatch.setattr(runtime, "make_flow_fn", make)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch,
                                   _altered_flow])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = configured(tiny_cell(name), monkeypatch)
    fault(monkeypatch, cell.traffic["attack"])
    out = _run(cell)
    assert not out["correct"], out["checks"]


def _wrap_iteration(monkeypatch, change):
    """Every L-BFGS iteration of the attack, followed by `change(state
    before, state after)`."""
    from pcfa_tpu_torch.attack import pcfa

    real = pcfa.lbfgs_iteration

    def iteration(fn, state, pos, *a, **k):
        new, loss = real(fn, state, pos, *a, **k)
        return change(state, new), loss

    monkeypatch.setattr(pcfa, "lbfgs_iteration", iteration)


def _pushed(old, new):
    """(pair, ring slot) of each pair the iteration pushed a pair for."""
    m = new.s_buf.shape[1]
    return [(b, int(old.count[b]) % m)
            for b in torch.nonzero(new.count > old.count).flatten().tolist()]


def _push_to_next_slot(old, new):
    m = new.s_buf.shape[1]
    for b, i in _pushed(old, new):
        new.s_buf[b, (i + 1) % m] = new.s_buf[b, i]
        new.s_buf[b, i] = 0
    return new


def _gradient_difference_doubled(old, new):
    for b, i in _pushed(old, new):
        new.y_buf[b, i] *= 2
    return new


def _iterate_frozen(old, new):
    return new._replace(x=old.x.clone())


def _first_step_doubled(old, new):
    first = ((old.n_iter == 0) & (new.n_iter == 1))[:, None]
    return new._replace(x=torch.where(first, 2 * new.x - old.x, new.x),
                        t=torch.where(first[:, 0], 2 * new.t, new.t))


def _stopped_after_first_iteration(old, new):
    first = (old.n_iter == 0) & (new.n_iter == 1)
    return new._replace(done=new.done | first)


@pytest.mark.parametrize("change", [_push_to_next_slot,
                                    _gradient_difference_doubled,
                                    _iterate_frozen, _first_step_doubled,
                                    _stopped_after_first_iteration])
@pytest.mark.parametrize("name", ["raft-pcfa-kitti-b2",
                                  "pwcnet-pcfa-kitti-b1"])
def test_a_broken_lbfgs_iteration_is_not_correct(name, change, monkeypatch):
    cell = configured(tiny_cell(name), monkeypatch)
    _wrap_iteration(monkeypatch, change)
    out = _run(cell)
    assert not out["correct"], out["checks"]
