"""The port's invariant lint (``repro_torch.analysis.lint``) on the CPU.

* The three rules carried over (``request-leak``, ``span-leak``,
  ``stream-order``) give the reference linter's findings (rule, line,
  column) on the reference's own fixtures.
* Each retargeted rule (``scatter-drop``, ``state-thread``,
  ``donated-use``, ``host-sync``) has positive and negative PyTorch
  fixtures, and a positive one stops being flagged when its rule is left
  out (the finding is that rule's).
* Pragmas, rule selection, ``--list-rules`` (the reference's seven
  names) and the CLI's exit codes; the port's tree lints clean.
"""

import os
import textwrap

import pytest

import test_analysis_lint as ref_fixtures
from repro.analysis import lint as jax_lint
from repro.analysis.rules import RULES_BY_NAME as JAX_RULES
from repro_torch.analysis.lint import PACKAGE_DIR, lint_paths, lint_source, main
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_NAME

PORT_SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
CARRIED = ("request-leak", "span-leak", "stream-order")


def _lint(snippet, rules=None):
    return lint_source(textwrap.dedent(snippet), "<fixture>", rules=rules)


def _rules_hit(snippet, rules=None):
    return sorted({f.rule for f in _lint(snippet, rules=rules)})


def _other_rules(name):
    return [r.name for r in ALL_RULES if r.name != name]


# ---------------------------------------------------------------------------
# the carried rules against the reference linter, on its fixtures
# ---------------------------------------------------------------------------

CARRIED_FIXTURES = [
    "REQUEST_BAD", "REQUEST_GOOD", "REQUEST_WAITALL", "REQUEST_EXC_PATH",
    "REQUEST_EXC_GOOD", "SPAN_BAD", "SPAN_GOOD_END", "SPAN_GOOD_WITH",
    "SPAN_GOOD_ATTR", "SPAN_DISCARDED", "SPAN_EXC_PATH", "SPAN_EXC_GOOD",
    "STREAM_BAD", "STREAM_GOOD", "USE_AFTER_FINISH", "RESTART_OK",
]


@pytest.mark.parametrize("fixture", CARRIED_FIXTURES)
def test_carried_rules_match_reference(fixture):
    src = textwrap.dedent(getattr(ref_fixtures, fixture))
    ref = jax_lint.lint_source(src, "<fixture>", rules=CARRIED)
    ours = lint_source(src, "<fixture>", rules=CARRIED)
    assert ([(f.rule, f.line, f.col, f.message) for f in ours]
            == [(f.rule, f.line, f.col, f.message) for f in ref])


def test_carried_rules_flag_the_reference_positives():
    for fixture in ("REQUEST_BAD", "REQUEST_EXC_PATH", "SPAN_BAD",
                    "SPAN_DISCARDED", "SPAN_EXC_PATH", "STREAM_BAD",
                    "USE_AFTER_FINISH"):
        assert _lint(getattr(ref_fixtures, fixture)), fixture


# ---------------------------------------------------------------------------
# scatter-drop
# ---------------------------------------------------------------------------

# a -1 table entry (a padding row) written into the pool: wraps to the
# last block
SCATTER_BAD = """
    def deposit(k_pool, block_tables, row, k):
        k_pool[block_tables[row]] = k
"""

SCATTER_BAD_METHOD = """
    def admit(tok_buf, slot, tok):
        tok_buf.index_copy_(0, slot, tok)
"""

# the port's convention: _write_targets selects only valid entries
SCATTER_GOOD = """
    def deposit(k_pool, block_tables, qpos, wvalid, k, bs):
        sel_b, sel_j, flat = _write_targets(block_tables, qpos, wvalid, bs)
        k_pool.view(-1, k.shape[-2], k.shape[-1])[flat] = k[sel_b, sel_j]
"""

# every row (arange) and a column aimed at the scratch column
SCATTER_GOOD_SCRATCH = """
    def write(cache, valid, qpos, W, v):
        rows = torch.arange(qpos.shape[0])[:, None]
        wcol = torch.where(valid, torch.remainder(qpos, W), W)
        cache["pos"][rows, wcol] = v
"""

# host bookkeeping: a list and a numpy table are not device pools
SCATTER_HOST = """
    def bind(self, slot, req, blocks):
        self._slot_req[slot] = req
        self._tables[slot, :len(blocks)] = blocks
"""

SCATTER_UNRELATED_INDEX = """
    def shift(cache, i, v):
        cache["k"][i] = v
"""


def test_scatter_drop_positive():
    assert _rules_hit(SCATTER_BAD) == ["scatter-drop"]


def test_scatter_drop_positive_tensor_method():
    assert _rules_hit(SCATTER_BAD_METHOD) == ["scatter-drop"]


def test_scatter_drop_negative_filtered():
    assert _rules_hit(SCATTER_GOOD) == []


def test_scatter_drop_negative_scratch_column():
    assert _rules_hit(SCATTER_GOOD_SCRATCH) == []


def test_scatter_drop_ignores_host_bookkeeping():
    assert _rules_hit(SCATTER_HOST) == []


def test_scatter_drop_ignores_unrelated_index_names():
    assert _rules_hit(SCATTER_UNRELATED_INDEX) == []


def test_scatter_drop_disabled():
    assert _rules_hit(SCATTER_BAD, rules=_other_rules("scatter-drop")) == []


# ---------------------------------------------------------------------------
# state-thread
# ---------------------------------------------------------------------------

# an innocuously named index ("idx"): scatter-drop does not see it, the
# carried-state target puts it in scope
STATE_BAD = """
    def scatter_state(cache, idx, new_conv):
        cache["conv"][0].index_copy_(0, idx, new_conv)
"""

STATE_BAD_ATTR = """
    def scatter_state(state, idx, v):
        state.ssm[idx] = v
"""

# the port's convention: dst/src from _row_indices (transformer.py)
STATE_GOOD = """
    def scatter_state(cache, rows, v):
        gather, dst, src = _row_indices(rows, cache["ssm"].shape[1], "cpu")
        cache["ssm"][0].index_copy_(0, dst, v.index_select(0, src))
"""

STATE_CONSTANT_INDEX = """
    def reset_first(cache, v):
        cache["conv"][0] = v
"""

STATE_UNRELATED_TARGET = """
    def scatter(x, idx, v):
        x.index_copy_(0, idx, v)
"""


def test_state_thread_positive_dict_leaf():
    assert _rules_hit(STATE_BAD) == ["state-thread"]


def test_state_thread_positive_attribute_leaf():
    assert _rules_hit(STATE_BAD_ATTR) == ["state-thread"]


def test_state_thread_negative_filtered_rows():
    assert _rules_hit(STATE_GOOD) == []


def test_state_thread_ignores_constant_index():
    assert _rules_hit(STATE_CONSTANT_INDEX) == []


def test_state_thread_ignores_unrelated_targets():
    assert _rules_hit(STATE_UNRELATED_TARGET) == []


def test_state_thread_disabled():
    assert _rules_hit(STATE_BAD, rules=_other_rules("state-thread")) == []


def test_state_thread_and_scatter_drop_complement():
    # a state leaf written through a raw slot index trips both rules, and
    # neither through the filtered rows
    src = """
    def scatter(cache, slots, v):
        cache["ssm"][0].index_copy_(0, slots, v)
    """
    assert _rules_hit(src) == ["scatter-drop", "state-thread"]
    fixed = src.replace(
        "    cache[",
        "    _, dst, _ = _row_indices(slots, 4, 'cpu')\n        cache[").replace(
        "0, slots, v", "0, dst, v")
    assert _rules_hit(fixed) == []


# ---------------------------------------------------------------------------
# donated-use (the in-place steps)
# ---------------------------------------------------------------------------

DONATED_BAD = """
    def drive(model, params, cache, toks, pos, tables):
        old_k = cache["k"]
        logits = model.decode_step_paged(params, cache, toks, pos, tables)
        return logits, old_k
"""

DONATED_GOOD_CLONE = """
    def drive(model, params, cache, toks, pos, tables):
        old_k = cache["k"].clone()
        logits = model.decode_step_paged(params, cache, toks, pos, tables)
        return logits, old_k
"""

DONATED_GOOD_ARG = """
    def drive(model, params, cache, toks, pos, tables):
        logits = model.decode_step_paged(params, cache, toks, pos, tables)
        return logits, cache["k"]
"""

DONATED_BAD_OPTIM = """
    def update(grads, state, params):
        before = state.m
        params, state, met = adamw_update(grads, state, params, lr=1e-3)
        return before
"""

DONATED_BAD_STEP = """
    def train(model, mesh_cfg, tcfg, state, batch):
        step = make_train_step(model, mesh_cfg, tcfg)
        master = state.opt.master
        new, met = step(state, batch)
        return master
"""

DONATED_REBIND = """
    def train(model, mesh_cfg, tcfg, state, batch):
        step = make_train_step(model, mesh_cfg, tcfg)
        master = state.opt.master
        state, met = step(state, batch)
        master = state.opt.master
        return master
"""


def test_donated_use_positive():
    hits = _lint(DONATED_BAD)
    assert [f.rule for f in hits] == ["donated-use"]
    assert "old_k" in hits[0].message and hits[0].line == 5


def test_donated_use_negative_clone():
    assert _rules_hit(DONATED_GOOD_CLONE) == []


def test_donated_use_reading_the_argument_is_fine():
    assert _rules_hit(DONATED_GOOD_ARG) == []


def test_donated_use_optimizer_and_train_step():
    assert _rules_hit(DONATED_BAD_OPTIM) == ["donated-use"]
    assert _rules_hit(DONATED_BAD_STEP) == ["donated-use"]


def test_donated_use_rebind_revives():
    assert _rules_hit(DONATED_REBIND) == []


def test_donated_use_disabled():
    assert _rules_hit(DONATED_BAD, rules=_other_rules("donated-use")) == []


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

HOST_SYNC_BAD = """
    def decode_step_paged(cfg, params, cache, tokens, positions, tables):
        n = int(positions.max().item())
        return _helper(cache, n)

    def _helper(cache, n):
        return cache["k"].nonzero()
"""

HOST_SYNC_BAD_ARG = """
    def prefill_chunk(cfg, params, cache, tokens, pos0, n_valid):
        if bool(n_valid):
            torch.cuda.synchronize()
"""

HOST_SYNC_GOOD = """
    def decode_step_paged(cfg, params, cache, tokens, positions, tables):
        return _helper(cache, positions + 1)

    def _helper(cache, n: int):
        return cache["k"] * int(n)

    def host_driver(logits):
        return logits.argmax(-1).tolist()
"""


def test_host_sync_positive():
    hits = _lint(HOST_SYNC_BAD)
    assert {f.rule for f in hits} == {"host-sync"}
    assert [f.line for f in hits] == [3, 7]   # .item(), the helper's nonzero


def test_host_sync_positive_argument_and_synchronize():
    assert len(_lint(HOST_SYNC_BAD_ARG)) == 2


def test_host_sync_negative():
    # outside the step bodies and their helpers, syncs are the host
    # driver's business; int() of a host-typed argument syncs nothing
    assert _rules_hit(HOST_SYNC_GOOD) == []


def test_host_sync_disabled():
    assert _rules_hit(HOST_SYNC_BAD, rules=_other_rules("host-sync")) == []


# ---------------------------------------------------------------------------
# pragmas, selection, syntax errors, the CLI
# ---------------------------------------------------------------------------

def test_pragma_suppresses_named_rule():
    src = SCATTER_BAD.replace("= k\n", "= k  # lint: ok[scatter-drop]\n")
    assert _rules_hit(src) == []


def test_pragma_on_preceding_line():
    src = """
    def deposit(k_pool, block_tables, row, k):
        # lint: ok
        k_pool[block_tables[row]] = k
"""
    assert _rules_hit(src) == []


def test_pragma_wrong_rule_does_not_suppress():
    src = SCATTER_BAD.replace("= k\n", "= k  # lint: ok[host-sync]\n")
    assert _rules_hit(src) == ["scatter-drop"]


def test_unknown_rule_selection_rejected():
    with pytest.raises(ValueError):
        lint_source("x = 1", rules=["no-such-rule"])


def test_syntax_error_is_a_finding():
    assert [f.rule for f in lint_source("def broken(:\n    pass")] == \
        ["syntax"]


def test_rule_names_equal_the_reference():
    assert list(RULES_BY_NAME) == list(JAX_RULES)


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    names = [line.split()[0] for line in
             capsys.readouterr().out.strip().splitlines()]
    assert names == list(JAX_RULES)


def test_port_tree_lints_clean():
    assert os.path.samefile(PACKAGE_DIR, PORT_SRC)
    findings = lint_paths([PORT_SRC])
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_default_is_the_port_and_clean(capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    assert out.startswith("clean:") and "7 rule(s)" in out


def test_cli_violation_exit(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(textwrap.dedent(SCATTER_BAD))
    assert main([str(tmp_path)]) == 1
    assert "scatter-drop" in capsys.readouterr().out
    assert main([str(tmp_path), "--rules", "host-sync"]) == 0
