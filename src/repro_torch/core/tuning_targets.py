"""The sharding (distribution-config) tuning space of a serving cell.

Port of ``repro/core/tuning_targets.py``, cut to ``sharding_space`` in its
narrow and wide forms: the grids, constraint names and space names are the
reference's, so a cell's ``dryrun[arch×shape×mesh]`` fingerprint is the
same digest in both packages and one store serves both. The wide MoE grids
(cartesian 9·10^7 to 1.1·10^9) build as a ``GenerativeSpace``, as the
reference's do. The serve control plane (``store/watch.py``,
``store/resolve.py``) keys sharding cells and prod telemetry on it. Cut:
``DryRunObjective`` (a multi-pod XLA dry-run compile, which has no meaning
on one card) and the ``hard`` variant (the TPU's VMEM residency model);
both wait for the distribution tooling.
"""
from __future__ import annotations

from repro_torch.core.searchspace import Param, SearchSpace, VectorConstraint

#: Tokens per global batch for the train shapes — microbatching must divide it.
GLOBAL_BATCH = 32


def sharding_space(arch: str, shape: str, wide: bool = False,
                   hard: bool = False) -> SearchSpace:
    """Distribution knobs applicable to the given cell.

    ``wide=True`` opens the full chunk-size grids (cartesian >10^6, >2M for
    MoE cells) with the physically-required combinations expressed as
    vectorized ``VectorConstraint`` column predicates — the scale the old
    per-row Python enumeration could not reach. The default narrow space is
    unchanged, so existing tuning caches and journals stay valid.

    ``hard=True`` (the reference's VMEM-coupled variant) is cut: it needs
    the TPU's VMEM residency model.
    """
    if hard:
        raise ValueError("sharding_space(hard=True) is cut from the port: it "
                         "needs the TPU's VMEM residency model and waits for "
                         "the distribution tooling (ROADMAP Queue 1)")
    if not wide:
        params = [
            Param("remat", ("none", "dots", "full")),
            Param("attn_q_chunks", (1, 2, 4)),
            Param("logits_chunk", (512, 2048, 8192)),
            Param("attn_block_kv", (512, 1024, 2048)),
            Param("flash", (1, 0)),   # 1: blockwise flash; 0: direct attention
        ]
        if shape == "train_4k":
            params.append(Param("opt_moment_dtype", ("float32", "bfloat16")))
            params.append(Param("microbatches", (1, 2, 4)))
        if arch.startswith(("deepseek", "qwen3")):
            params.append(Param("capacity_factor", (1.0, 1.25, 1.5)))
            params.append(Param("experts_rule", ("model", "model+data")))
        if arch.startswith("xlstm"):
            params.append(Param("mlstm_chunk", (0, 32, 64, 128)))
        params.append(Param("embed_rule", ("data", "none")))  # ZeRO-3 on/off
        return SearchSpace(params, (), name=f"sharding[{arch}×{shape}]")

    params = [
        Param("remat", ("none", "dots", "full")),
        Param("attn_q_chunks", (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)),
        Param("logits_chunk", (128, 192, 256, 384, 512, 768, 1024, 1536,
                               2048, 3072, 4096, 6144, 8192, 12288, 16384,
                               32768)),
        Param("attn_block_kv", (128, 192, 256, 384, 512, 768, 1024, 1536,
                                2048, 3072, 4096)),
        Param("flash", (1, 0)),
    ]
    cons = [
        # blockwise flash needs at least a 256-token KV block per grid step
        VectorConstraint(lambda c: (c["flash"] == 0)
                         | (c["attn_block_kv"] >= 256),
                         name="flash_min_kv_block"),
        # direct attention materializes the (q, kv) block: cap the KV tile
        VectorConstraint(lambda c: (c["flash"] == 1)
                         | (c["attn_block_kv"] <= 2048),
                         name="direct_max_kv_block"),
        # combined q-chunk × kv-block tiling degenerates past this product
        VectorConstraint(lambda c: c["attn_q_chunks"] * c["attn_block_kv"]
                         <= 32768, name="tile_product"),
    ]
    if shape == "train_4k":
        params.append(Param("opt_moment_dtype", ("float32", "bfloat16")))
        params.append(Param("microbatches", tuple(
            m for m in (1, 2, 4, 8, 16, 32) if GLOBAL_BATCH % m == 0)))
        # vacuous for the derived grid above; keeps the coupling declared if
        # the grid is ever widened past the divisors
        cons.append(VectorConstraint(
            lambda c: GLOBAL_BATCH % c["microbatches"] == 0,
            name="microbatch_divides_batch"))
    if arch.startswith(("deepseek", "qwen3")):
        # MoE cells get the full distribution-knob grid: cartesian goes past
        # 10^9 on train_4k, which the generative backend (DESIGN.md §15)
        # serves without enumeration. Narrow/trimmed MoE fingerprints are
        # intentionally incompatible with this wide grid (extra params), so
        # cross-width transfer is off for MoE cells — by design, not drift.
        params.append(Param("capacity_factor", (1.0, 1.05, 1.1, 1.25, 1.4,
                                                1.5, 1.6, 1.75, 2.0)))
        params.append(Param("experts_rule", ("model", "model+data")))
        params.append(Param("attn_block_q", (128, 192, 256, 384, 512, 768,
                                             1024, 1536, 2048, 3072, 4096)))
        params.append(Param("moe_combine", ("gather", "a2a")))
        params.append(Param("grad_compression", ("none", "topk", "int8")))
        params.append(Param("grad_compression_topk", (0.01, 0.05, 0.1)))
        cons += [
            # blockwise flash keeps a q×kv f32 accumulator tile in VMEM
            VectorConstraint(lambda c: (c["flash"] == 0)
                             | (c["attn_block_q"] * c["attn_block_kv"]
                                <= 2 ** 21),
                             name="flash_q_kv_vmem"),
            # the top-k ratio only exists under top-k compression; pin it to
            # its default otherwise so the knob can't split identical configs
            VectorConstraint(lambda c: (c["grad_compression"] == "topk")
                             | (c["grad_compression_topk"] == 0.05),
                             name="topk_ratio_coupling"),
        ]
    if arch.startswith("xlstm"):
        params.append(Param("mlstm_chunk", (0, 16, 32, 48, 64, 96, 128,
                                            192, 256)))
    params.append(Param("embed_rule", ("data", "none")))  # ZeRO-3 on/off
    return SearchSpace(params, cons, name=f"sharding_wide[{arch}×{shape}]")
