"""The comparison that decides ``correct``, driven as a run drives it (the
look for a card left out) at a smoke size on the CPU: sound runs pass;
the control (the reference in fp8 in the program's place) and each fault
a serving cell can have fail. A cell on one card has no exchange between
cards to leave out.

The smoke limit is set as a cell's is, from readings of this size: sound
runs on seeds 0-5 read at most 0.0018, the control at least 0.0082."""
import json
from pathlib import Path

import pytest
import torch

from chipbench import correct, harness

HERE = Path(__file__).resolve().parent
LIMIT = 0.004
SEEDS = (0, 1, 2)


def cell():
    with open(HERE / "testdata" / "smoke.json", encoding="utf-8") as f:
        c = json.load(f)
    return harness.Cell("smoke", c, {"batch": 4, "prompt": 64, "output": 16},
                        {"requests": 8, "limits": {"max_gap": LIMIT}},
                        family=harness.family("dense"))


def run_cell(seed, **kw):
    run, finished, weights = harness.serve(
        cell(), seed, 0.0, device="cpu", t0=0.0, batches=2,
        log=lambda *a: None, **kw)
    return run, finished, weights


def is_correct(run, finished, weights, seed):
    compared, tokens = harness.check(run, finished, weights, seed)
    assert tokens == 8 * 16
    return all(c["value"] <= c["limit"] for c in compared.values())


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_runs_are_correct_and_the_control_is_not(seed):
    run, finished, weights = run_cell(seed)
    assert run.batches == 2 and run.tokens == 2 * 4 * 16
    assert is_correct(run, finished, weights, seed)
    got = correct.compare(cell(), weights, finished, 8, seed, control=True)
    assert got["control_gap"] > LIMIT


def _stuck(self):
    """A decode step that returns its state unchanged: no token computed,
    the last one served again."""
    self.out.append(self.toks)
    self.pos += 1
    return 0.0


def _halved(orig):
    def prefill_batch(self, batch):
        """Half of the batch left out: the first half's prompts stand in
        for the second half's."""
        t = batch["tokens"]
        h = t.shape[0] // 2
        return orig(self, {"tokens": torch.cat([t[:h], t[:h]])})
    return prefill_batch


def _altered(orig):
    def decode_step(self):
        """One served token altered where it is produced (each row's
        third)."""
        dt = orig(self)
        if len(self.out) == 3:
            self.toks = (self.toks + 1) % self.cfg.vocab_size
            self.out[-1] = self.toks
        return dt
    return decode_step


@pytest.mark.parametrize("fault", ["stuck", "halved", "altered"])
def test_each_fault_makes_the_run_incorrect(monkeypatch, fault):
    from repro_torch.launch.serve import DecodeServer
    if fault == "stuck":
        monkeypatch.setattr(DecodeServer, "decode_step", _stuck)
    elif fault == "halved":
        monkeypatch.setattr(DecodeServer, "prefill_batch",
                            _halved(DecodeServer.prefill_batch))
    else:
        monkeypatch.setattr(DecodeServer, "decode_step",
                            _altered(DecodeServer.decode_step))
    run, finished, weights = run_cell(SEEDS[0])
    assert not is_correct(run, finished, weights, SEEDS[0])


def test_the_sample_is_drawn_from_the_seed_from_every_part_of_a_batch():
    a = correct.sample_requests(10, 32, 4, 5)
    assert a == correct.sample_requests(10, 32, 4, 5) and len(set(a)) == 4
    assert a != correct.sample_requests(10, 32, 4, 6)
    assert correct.sample_requests(1, 4, 6, 5) == [(0, r) for r in range(4)]
    for seed in range(50):
        # one from each quarter of a batch's rows
        rows = sorted(r for _, r in correct.sample_requests(7, 32, 4, seed))
        assert [r // 8 for r in rows] == [0, 1, 2, 3], rows
        # more than a batch: every row, none twice
        got = correct.sample_requests(3, 4, 6, seed)
        assert len(set(got)) == 6 and {r for _, r in got} == set(range(4))


@pytest.mark.parametrize("requests", [2, 3])
def test_half_a_batch_left_out_fails_a_sample_smaller_than_the_batch(
        monkeypatch, requests):
    """A cell compares a few of its requests; the fault in the second half
    of every batch fails it on every seed all the same."""
    from repro_torch.launch.serve import DecodeServer
    monkeypatch.setattr(DecodeServer, "prefill_batch",
                        _halved(DecodeServer.prefill_batch))
    run, finished, weights = run_cell(SEEDS[0])
    run.cell.check["requests"] = requests
    for seed in range(20):
        compared, tokens = harness.check(run, finished, weights, seed)
        assert tokens == requests * 16
        assert compared["max_gap"]["value"] > LIMIT, seed
