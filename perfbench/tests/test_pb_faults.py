"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip skipped, everything else as a run on the
card, at a tiny width on the CPU.  The faults are planted in the
program: a served token altered where the sampler produces it, a decode
step that leaves its cache as it was, a decode step that feeds one slot
of the batch another token than it served, a training step that returns its
state unchanged, and one that leaves half of each batch out (the mean
over the rest).  A cell on one chip has no exchange between chips to
leave out."""
import pytest
import torch

from conftest import tiny_ctx
from pbcore import cell

SERVE = ["qwen2vl7b.chat_prefix", "dsmoe16b.unique_docs"]


def outcome(name: str, seed: int = 2 ** 33 + 1) -> dict:
    ctx = tiny_ctx(name, seed=seed)
    return cell.result(ctx, cell.run(ctx))


@pytest.mark.parametrize("name", SERVE + ["qwen2vl7b.train_4k"])
def test_sound_runs_are_correct(name):
    out = outcome(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("name", SERVE)
def test_token_altered_where_produced(name, monkeypatch):
    from repro_torch.serving import sampler
    greedy = sampler.greedy

    def bad_greedy(logits):
        tok = greedy(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(sampler, "greedy", bad_greedy)
    out = outcome(name)
    assert not out["correct"]
    assert out["checks"]["token_mismatch"]["value"] > 0


@pytest.mark.parametrize("name", SERVE)
def test_decode_step_leaves_its_state(name, monkeypatch):
    from repro_torch.models.transformer import LM
    orig, first = LM.decode_step, {}

    def decode_step(self, tokens, caches, cur_pos):
        pos = first.setdefault(id(caches), cur_pos)
        return orig(self, tokens, caches, pos)
    monkeypatch.setattr(LM, "decode_step", decode_step)
    out = outcome(name)
    assert not out["correct"]
    c = out["checks"]["logit_err"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("name", SERVE)
def test_decode_step_corrupts_one_slot(name, monkeypatch):
    import calibrate
    from repro_torch.models.transformer import LM
    orig = LM.decode_step

    def decode_step(self, tokens, caches, cur_pos):
        return orig(self, calibrate.last_slot_altered(tokens, 512), caches,
                    cur_pos)
    monkeypatch.setattr(LM, "decode_step", decode_step)
    out = outcome(name)
    assert not out["correct"]
    c = out["checks"]["req_err"]
    assert c["value"] > c["limit"]


def test_train_step_returns_its_state_unchanged(monkeypatch):
    from repro_torch.optim import adamw

    def update(self, grads, state, params):
        return params, adamw.AdamWState(state.step + 1, state.mu, state.nu)
    monkeypatch.setattr(adamw.AdamW, "update", update)
    out = outcome("qwen2vl7b.train_4k")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_step_leaves_half_the_batch_out(monkeypatch):
    import calibrate
    from repro_torch.models.transformer import LM
    monkeypatch.setattr(LM, "loss", calibrate._half_loss(LM.loss))
    assert not outcome("qwen2vl7b.train_4k")["correct"]
