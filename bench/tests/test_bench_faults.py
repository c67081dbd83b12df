"""The comparison that decides ``correct``, driven through a whole run
at a CPU size (the look for a card skipped): sound, it passes; with the
timed path broken underneath, it fails. The faults a serving cell can
have: a token altered where it is produced; a step that returns its
state unchanged (the decode step's cache and carried state restored
after it); half of a chunk batch left out (every other chunk row
deposits nothing, as if it had). A cell on one card has no exchange
between cards to leave out. Each fault is held to the number the cell
itself compares (the mean gap for olmoe, the widest for mamba2) and to
the widest gap."""

import time

import pytest

from conftest import SMALL, SMALL_LIMIT, own_number, small_spec

CELLS = sorted(SMALL)
#: (cell, number): each cell's own number, and the widest gap
NUMBERED = sorted({(c, n) for c in CELLS
                   for n in (own_number(c), "logit_gap")})


def _run(spec, seed=2 ** 31 + 3):
    from bench.run import run_cell
    return run_cell(spec, seed, 2.0, False, device="cpu",
                    t_start=time.perf_counter())


def _token_altered(monkeypatch, vocab):
    from repro_torch.serve import engine
    real = engine._sample

    def altered(logits, temps, gens):
        out = real(logits, temps, gens)
        out[0] = (out[0] + 1) % vocab
        return out
    monkeypatch.setattr(engine, "_sample", altered)


def _state_unchanged(monkeypatch, vocab):
    from repro_torch.models import transformer
    real = transformer.decode_step_paged

    def frozen(cfg, params, cache, *a, **kw):
        keep = {k: v.clone() for k, v in cache.items()}
        out = real(cfg, params, cache, *a, **kw)
        for k, v in keep.items():
            cache[k].copy_(v)
        return out
    monkeypatch.setattr(transformer, "decode_step_paged", frozen)


def _half_batch(monkeypatch, vocab):
    from repro_torch.models import transformer
    real = transformer.prefill_chunk_paged

    def half(cfg, params, cache, tokens, tables, rows, pos0, n_valid, **kw):
        n_valid = n_valid.clone()
        n_valid[1::2] = 0
        return real(cfg, params, cache, tokens, tables, rows, pos0, n_valid,
                    **kw)
    monkeypatch.setattr(transformer, "prefill_chunk_paged", half)


FAULTS = {"token_altered": _token_altered, "state_unchanged":
          _state_unchanged, "half_batch": _half_batch}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = _run(small_spec(cell))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert list(res["checks"]) == [own_number(cell)]
    assert res["checks"][own_number(cell)]["value"] <= SMALL_LIMIT


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell,number", NUMBERED)
def test_a_broken_run_is_not_correct(cell, number, fault, monkeypatch):
    spec = small_spec(cell, number)
    # every finished request compared, so the fault's rows are in it
    spec.wl["check"] = dict(spec.wl["check"], requests=1000)
    FAULTS[fault](monkeypatch, spec.cfg["port"]["vocab_size"])
    res = _run(spec)
    assert list(res["checks"]) == [number]
    assert not res["correct"], res["checks"]
