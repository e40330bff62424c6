"""The family seam (``families/``): a family and a configuration of it are
added to the benchmark by adding files alone, and the dense family's
weights and reference give what they gave before the seam (checksums
frozen from the code before it, at the smoke configuration)."""
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

import chipbench.families
from chipbench import harness
from chipbench.families import dense
from chipbench.trace import TraceWindow
from chipbench.weights import Prompts

HERE = Path(__file__).resolve().parent

#: sha256 of every leaf's path and values (as fp32) in path order, and the
#: reference's logits, at ``testdata/smoke.json`` in bf16, from the
#: harness's code before the family seam
WEIGHTS_SHA = {
    7: "e1791ebc4caea3f1cf0bb44beb4e4c6bdbc804f86abbf2d5a91188862e84245a",
    2**31 + 7:
        "3c606a3d1a760daed4fe7358dc005abc3ab4f4eff51517f8a549b47b31a9cfe7",
}
LOGITS = {"sum": -7.096425146854017, "abs_sum": 1043.1968807678786,
          "max": 0.5857172608375549}


def smoke():
    with open(HERE / "testdata" / "smoke.json", encoding="utf-8") as f:
        return json.load(f)


def flat(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, sub in items:
        yield from flat(sub, path + (key,))


def digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in sorted(flat(tree), key=lambda kv: str(kv[0])):
        h.update(str(path).encode())
        h.update(t.float().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(WEIGHTS_SHA))
def test_the_dense_family_reads_as_before_the_seam(seed):
    c = smoke()
    m = dense.sizes(c)
    w = dense.make_weights(m, torch.bfloat16, seed, "cpu")
    assert digest(w) == WEIGHTS_SHA[seed]
    if seed != 7:
        return
    # one sample of two requests: prompts of 64 and 16 "served" ids, both
    # drawn from the seed's prompt stream (so that the program's tokens,
    # which a change of the port may move, do not enter the checksum)
    p = Prompts(seed, m.vocab, 2, 64, "cpu")
    prompts, served = p.next(), p.next()[:, :16]
    ref = dense.reference(c, w).served_logits(prompts, served)
    assert ref.shape == (2, 16, 256)
    assert float(ref.double().abs().sum()) == pytest.approx(
        LOGITS["abs_sum"], rel=1e-6)
    assert float(ref.double().sum()) == pytest.approx(LOGITS["sum"],
                                                      abs=1e-4)
    assert float(ref.max()) == pytest.approx(LOGITS["max"], rel=1e-6)


#: a family that is the dense one, recording each call of its interface
RECORDED = '''
from chipbench.families import dense

CALLS = []
NAMES = ("sizes", "arch_config", "make_weights", "reference",
         "products_bound_s", "model_flops", "flash_attention_bound_s",
         "decode_attention_bound_s")


def _recorded(name):
    def call(*args, **kwargs):
        CALLS.append(name)
        return getattr(dense, name)(*args, **kwargs)
    return call


for _name in NAMES:
    globals()[_name] = _recorded(_name)
'''


def files(root: Path):
    return {str(p.relative_to(root)): (p.stat().st_mtime_ns, p.stat().st_size)
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_and_its_configuration_are_added_by_files_alone(
        tmp_path, monkeypatch, request):
    """A family file, a configuration naming it, a traffic file and a
    cell's check file, all outside the benchmark's directory (the
    families' package path and the harness's root pointed there): the
    harness loads the cell, serves it (smoke size, CPU), reads its metrics
    and compares it, reaching the model only through the new family."""
    before = files(HERE)
    root = tmp_path / "chipbench"
    for d in ("families", "configs", "traffic", "cells"):
        (root / d).mkdir(parents=True)
    (root / "metrics").symlink_to(HERE / "metrics")
    (root / "families" / "recorded.py").write_text(RECORDED)
    conf = {**smoke(), "name": "recorded-smoke", "family": "recorded"}
    (root / "configs" / "recorded-smoke.json").write_text(json.dumps(conf))
    (root / "traffic" / "smoke.json").write_text(json.dumps(
        {"kind": "closed_batches", "batch": 4, "prompt": 64, "output": 16}))
    (root / "cells" / "recorded-smoke.smoke.json").write_text(json.dumps(
        {"requests": 8, "limits": {"max_gap": 0.004}}))
    with open(HERE.parent / "BENCHMARK.json", encoding="utf-8") as f:
        real = json.load(f)
    strip = lambda ms: [{k: v for k, v in m.items() if k != "workloads"}
                        for m in ms]
    bench = {"configs": [{"name": "recorded-smoke",
                          "file": "chipbench/configs/recorded-smoke.json"}],
             "workloads": [{"name": "recorded-smoke.smoke",
                            "config": "recorded-smoke", "traffic": "smoke",
                            "chips": 1}],
             "end_to_end": strip(real["end_to_end"]),
             "per_layer": strip(real["per_layer"])}
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(chipbench.families, "__path__",
                        [str(root / "families"),
                         *chipbench.families.__path__])
    request.addfinalizer(
        lambda: sys.modules.pop("chipbench.families.recorded", None))

    cell = harness.load_cell(bench, "recorded-smoke.smoke")
    assert Path(cell.family.__file__) == root / "families" / "recorded.py"
    run, finished, weights = harness.serve(
        cell, 0, 0.0, device="cpu", t0=0.0, trace=False, batches=2,
        log=lambda *a: None)
    e2e = harness.read_metrics(bench, run, False)
    # a made-up profile of the batch, so that every count's reader reads
    run.trace = TraceWindow(1.0, 1.0, [(k, 0, 10**6) for k in (
        "nvjet_x", "flash_tc_kernel<64>", "decode_split_kernel<bf16>")])
    per_layer = harness.read_metrics(bench, run, True)
    compared, tokens = harness.check(run, finished, weights, 0)

    assert set(cell.family.CALLS) == set(cell.family.NAMES)
    assert {"output_tok_s", "ttft_p95_ms", "itl_p95_ms",
            "setup_s"} <= set(e2e)
    assert {"step.mfu_pct", "products.roofline_pct",
            "flash_attention.roofline_pct",
            "flash_decode.roofline_pct"} <= set(per_layer)
    assert tokens == 8 * 16 and compared["max_gap"]["value"] <= 0.004
    assert files(HERE) == before
