"""A plain dense decoder in fp32, TF32 off: the reference of the ``dense``
family's cells (``families/dense.py``).

It follows the equations of the port's dense ``ArchConfig`` models, which
the configuration files state (and where they depart from the published
model): token embedding; per layer RMSNorm (fp32, eps from the file),
q/k/v projections, rotary embedding over the whole head (rotate-half,
frequencies theta^(-i / (hd/2))), causal softmax attention with query head
h reading KV head h // (H / KV) at scale 1/sqrt(hd), the output
projection and a residual add, then RMSNorm, a SwiGLU MLP
(silu(x Wg) * (x Wu)) Wd and a residual add; a final RMSNorm and an untied
head. It reads the prompt and the served tokens whole (no cache) and
returns the logits at the positions that chose the served tokens.

It runs layer by layer on the weights' device, each weight cast to fp32
when a product needs it, the MLP in blocks of rows and the attention in
blocks of queries, so that it fits beside the bf16 weights.

``fp8=True`` is the control: every weight product computed from operands
rounded to float8 e4m3, each row of the activations and each output
column of a weight scaled to e4m3's largest value (as W8A8 serving
quantizes them), the product summed in fp32; the rest as above.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
MLP_ROWS = 8192
Q_BLOCK = 512


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3, each slice along ``dim`` scaled so that its
    largest magnitude is e4m3's largest, and scaled back (fp32)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Decoder:
    """The reference over one configuration file's numbers (``c``) and a
    weight tree in the program's layout (any dtype; read, never
    written)."""

    def __init__(self, c: Dict, weights: Dict, *, fp8: bool = False):
        if c["partial_rotary_factor"] != 1.0 or c["norm_type"] != "rms":
            raise ValueError("the reference runs RMSNorm and full rotary "
                             "embeddings only")
        self.heads, self.head_dim = c["num_attention_heads"], c["head_dim"]
        self.d_ff = c["intermediate_size"]
        self.eps = float(c["norm_eps"])
        self.theta = float(c["rope_theta"])
        self.w = weights
        self.fp8 = fp8

    def _weight(self, w: torch.Tensor, k: int) -> torch.Tensor:
        w = w.reshape(k, -1).float()
        return fp8_round(w, 0) if self.fp8 else w

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (fp8_round(x, 1) if self.fp8 else x) @ w

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * scale.float()

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, heads, hd) at positions 0 .. T-1."""
        T, _, hd = x.shape
        half = hd // 2
        freqs = self.theta ** (-torch.arange(half, dtype=torch.float32,
                                             device=x.device) / half)
        ang = torch.arange(T, dtype=torch.float32,
                           device=x.device)[:, None] * freqs
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """Causal attention of one sequence: q (T, H, hd), k and v
        (T, KV, hd), in blocks of queries."""
        T, H, hd = q.shape
        G = H // k.shape[1]
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(hd)
        pos = torch.arange(T, device=q.device)
        for lo in range(0, T, Q_BLOCK):
            hi = min(T, lo + Q_BLOCK)
            s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) * scale
            s = s.masked_fill(pos[None, None, :hi] > pos[lo:hi, None],
                              -math.inf)
            out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                      v[:hi])
        return out

    def _layer(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        """One layer over x (R, T, d), fp32."""
        R, T, d = x.shape
        a = p["attn"]
        h = self._norm(x, p["ln1"]["scale"]).reshape(R * T, d)
        q, k, v = (self._mm(h, self._weight(a[n], d)).reshape(R, T, -1,
                                                              self.head_dim)
                   for n in ("wq", "wk", "wv"))
        att = torch.stack([self._attention(self._rope(q[r]),
                                           self._rope(k[r]), v[r])
                           for r in range(R)])
        del q, k, v
        wo = self._weight(a["wo"], self.heads * self.head_dim)
        x = x + self._mm(att.reshape(R * T, -1), wo).reshape(R, T, d)
        del att, wo
        h = self._norm(x, p["ln2"]["scale"]).reshape(R * T, d)
        wg, wu = (self._weight(p["mlp"][n], d) for n in ("wg", "wu"))
        wd = self._weight(p["mlp"]["wd"], self.d_ff)
        y = torch.empty_like(h)
        for lo in range(0, R * T, MLP_ROWS):
            hc = h[lo:lo + MLP_ROWS]
            y[lo:lo + MLP_ROWS] = self._mm(
                F.silu(self._mm(hc, wg)) * self._mm(hc, wu), wd)
        return x + y.reshape(R, T, d)

    def served_logits(self, prompts: torch.Tensor, served: torch.Tensor
                      ) -> torch.Tensor:
        """The logits (R, n, V) at the positions that chose each of the n
        served tokens: the prompt's last, then each served token fed but
        the last. ``prompts`` (R, S) and ``served`` (R, n) token ids."""
        S = prompts.shape[1]
        seq = torch.cat([prompts, served[:, :-1]], dim=1)
        with exact_fp32(), torch.no_grad():
            x = self.w["embed"]["table"][seq].float()
            for p in self.w["layers"]:
                x = self._layer(p, x)
            x = self._norm(x[:, S - 1:], self.w["final_norm"]["scale"])
            R, n, d = x.shape
            head = self._weight(self.w["lm_head"]["w"], d)
            return self._mm(x.reshape(R * n, d), head).reshape(R, n, -1)
