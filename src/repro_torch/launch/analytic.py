"""Analytic FLOP model: inner-scan corrections + full-model cross-check.

A copy of ``repro/launch/analytic.py``, the code unchanged (pinned equal in
``tests/test_torch_copies.py``). There, XLA's ``cost_analysis`` counts a
while-loop body once, so the JAX dry-run adds ``corrections_dev`` (the
q-chunk attention scan and the Mamba-2 SSD chunk scan, ``body_flops x
(trips - 1)``). The port's dry-run runs every chunk eagerly and counts it,
so it records ``corrections_dev`` beside its count and does not add it.
``model_flops_analytic_dev`` is the independent full-model estimate and the
base of the useful-FLOPs ratio 6·N_active·D / total.
"""
from __future__ import annotations


from repro_torch.configs.base import ArchConfig, ShapeSpec


def _shards(n: int, ax: int) -> int:
    """Ways an n-sized dim actually shards over an ax-way mesh axis."""
    return ax if (ax and n % ax == 0) else 1


class CellModel:
    """Closed-form per-device FLOPs for one (arch, shape, mesh) cell."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, mesh_shape: dict,
                 micro_global_batch: int = 0):
        self.cfg, self.shape = cfg, shape
        self.model_ax = mesh_shape.get("model", 1)
        self.batch_shards = (mesh_shape.get("data", 1)
                             * mesh_shape.get("pod", 1))
        B = micro_global_batch or shape.global_batch
        self.B_d = max(1, B // self.batch_shards)
        self.T = shape.seq_len
        # train multiplier: fwd + remat-refwd + 2x bwd (full remat)
        self.mult = {"train": 4.0, "prefill": 1.0, "decode": 1.0}[shape.kind]

    # -- attention ------------------------------------------------------------
    def attn_layer_flops_dev(self, window=None) -> float:
        """Per-device quadratic-attention FLOPs for ONE layer, fwd only."""
        cfg = self.cfg
        H_d = self.cfg.num_heads // _shards(cfg.num_heads, self.model_ax)
        T_d = self.T // (_shards(self.T, self.model_ax)
                         if cfg.seq_shard_attn else 1)
        if cfg.seq_shard_attn:      # seq- and head-sharding are alternatives
            H_d = cfg.num_heads
        chunk = cfg.attn_chunk_q or self.T
        S_eff = self.T if window is None else min(self.T, window + chunk)
        return 4.0 * self.B_d * H_d * T_d * S_eff * cfg.head_dim

    def attn_scan_correction_dev(self, n_layers_global, n_layers_local) -> float:
        """Extra FLOPs XLA missed for scanned q-chunk attention."""
        cfg = self.cfg
        if cfg.attn_chunk_unroll or not cfg.attn_chunk_q \
                or self.T <= cfg.attn_chunk_q:
            return 0.0
        n = self.T // cfg.attn_chunk_q
        f = (n_layers_global * self.attn_layer_flops_dev(None)
             + n_layers_local * self.attn_layer_flops_dev(cfg.local_window))
        return f * (n - 1) / n * self.mult

    # -- mamba2 SSD -------------------------------------------------------------
    def ssd_layer_flops_dev(self) -> float:
        cfg = self.cfg
        H = cfg.ssm_heads
        H_d = H // _shards(cfg.d_inner, self.model_ax)  # act_inner sharding
        P, N, Q = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        B, T = self.B_d, self.T
        # CB (2TQN) + y_intra (2TQ H P) + states (2T H P N) + y_inter (4T H P N)
        return B * T * (2.0 * Q * N + 2.0 * Q * H_d * P
                        + 6.0 * H_d * P * N)

    def ssd_scan_correction_dev(self, n_ssd_layers: int) -> float:
        cfg = self.cfg
        if not n_ssd_layers or self.T <= cfg.ssm_chunk:
            return 0.0
        nc = self.T // cfg.ssm_chunk
        return (self.ssd_layer_flops_dev() * (nc - 1) / nc * n_ssd_layers
                * self.mult)

    def corrections_dev(self) -> float:
        kinds = self.cfg.layer_kinds()
        if self.shape.kind == "decode":
            return 0.0
        return (self.attn_scan_correction_dev(
                    kinds.count("global"), kinds.count("local"))
                + self.ssd_scan_correction_dev(kinds.count("ssd")))

    def bytes_corrections_dev(self) -> float:
        """HBM-byte corrections for loop bodies XLA counted once.

        Uses FLASH-ATTENTION I/O semantics for the q-chunk loop (the TPU
        target never writes O(T^2) scores to HBM — our Pallas kernel keeps
        score tiles in VMEM): each extra chunk re-reads K/V and does one
        q/o chunk r/w. The SSD loop correction uses an arithmetic-intensity
        heuristic (~8 flop/byte for its small einsums).
        """
        cfg = self.cfg
        if self.shape.kind == "decode":
            return 0.0
        kinds = cfg.layer_kinds()
        total = 0.0
        if (not cfg.attn_chunk_unroll and cfg.attn_chunk_q
                and self.T > cfg.attn_chunk_q):
            n = self.T // cfg.attn_chunk_q
            K_d = cfg.num_kv_heads // _shards(cfg.num_kv_heads, self.model_ax)
            H_d = cfg.num_heads // _shards(cfg.num_heads, self.model_ax)
            kv = 2.0 * self.B_d * self.T * K_d * cfg.head_dim * 2  # bf16
            qo = 2.0 * self.B_d * self.T * H_d * cfg.head_dim * 2
            n_attn = kinds.count("global") + kinds.count("local")
            total += (n - 1) * (kv + qo / n) * n_attn * self.mult
        if kinds.count("ssd") and self.T > cfg.ssm_chunk:
            nc = self.T // cfg.ssm_chunk
            total += (self.ssd_layer_flops_dev() / 8.0 * (nc - 1) / nc
                      * kinds.count("ssd") * self.mult)
        return total

    # -- HBM traffic model --------------------------------------------------------
    def hbm_bytes_dev(self, n_micro: int = 1, params_total: int = 0) -> float:
        """Analytic per-device HBM bytes for ONE FULL STEP (n_micro micro
        steps + apply for train). XLA's 'bytes accessed' is a pre-fusion
        upper bound (measured 10-100x the touched bytes on the CPU backend),
        so the roofline memory term uses this model instead; the raw XLA
        number is recorded alongside as the upper bound.

        Model: weights are FSDP-gathered per pass (bf16, /model-shards
        resident view), activations make ~2 HBM round-trips per major tensor
        per pass, 3 passes for train (fwd + remat-refwd + bwd), 1 otherwise;
        KV caches are written at prefill and read at decode; flash-attention
        K/V reloads are already in bytes_corrections_dev.
        """
        cfg = self.cfg
        mx = self.model_ax
        P = params_total or cfg.param_count()
        passes = 3.0 if self.shape.kind == "train" else 1.0
        T = 1 if self.shape.kind == "decode" else self.T
        tok = self.B_d * T

        # weights touched per pass: gathered over data, still sharded over
        # model where the axes divide (~dominant matrices do)
        w_pass = 2.0 * P / mx
        weights = passes * w_pass * n_micro
        if self.shape.kind == "train":
            weights += n_micro * 8.0 * P / (mx * self.batch_shards)  # grad acc
            weights += 28.0 * P / (mx * self.batch_shards)           # apply

        # activations: bytes per token per layer (bf16, ~2 r/w per tensor)
        kinds = cfg.layer_kinds()
        act_per_tok = 0.0
        for k in kinds:
            D = cfg.d_model
            c = 8.0 * D                                   # residual stream
            if k in ("global", "local"):
                H_d = cfg.num_heads // _shards(cfg.num_heads, mx)
                K_d = cfg.num_kv_heads // _shards(cfg.num_kv_heads, mx)
                c += 4.0 * (H_d + K_d) * cfg.head_dim
            elif k == "ssd":
                c += 6.0 * cfg.d_inner / _shards(cfg.d_inner, mx)
            elif k == "rglru":
                W = cfg.lru_width or D
                c += 6.0 * W / _shards(W, mx)
            if cfg.d_ff and k != "ssd":
                if cfg.num_experts:
                    c += 4.0 * cfg.top_k * D              # dispatch+combine
                    c += 4.0 * cfg.d_ff * cfg.top_k / _shards(cfg.d_ff, mx)
                else:
                    c += 4.0 * cfg.d_ff / _shards(cfg.d_ff, mx)
            act_per_tok += c
        act = passes * tok * act_per_tok * 2.0 * n_micro  # bf16

        # logits / CE (train): bf16 logits + f32 softmax r/w
        V_d = cfg.vocab_size / _shards(cfg.vocab_size, mx)
        logits = (tok * V_d * 10.0 * n_micro
                  if self.shape.kind == "train" else self.B_d * V_d * 6.0)

        # caches
        cache = 0.0
        for k in kinds:
            if k in ("global", "local"):
                S = self.shape.seq_len if k == "global" else min(
                    cfg.local_window, self.shape.seq_len)
                S_d = S / _shards(S, mx)
                per = 2.0 * self.B_d * S_d * cfg.num_kv_heads * cfg.head_dim \
                    * 2.0
                if self.shape.kind == "prefill":
                    cache += per                           # write k,v
                elif self.shape.kind == "decode":
                    cache += per                           # read k,v
            elif k in ("ssd", "rglru") and self.shape.kind != "train":
                cache += 4.0 * self.B_d * (cfg.d_inner if k == "ssd"
                                           else (cfg.lru_width or cfg.d_model))
        return weights + act + logits + cache + self.bytes_corrections_dev()

    # -- full model (validation / useful-ratio) ---------------------------------
    def model_flops_analytic_dev(self) -> float:
        """Independent per-device estimate of the whole step, fwd-only base
        x train multiplier. Matmul terms only (elementwise is noise)."""
        cfg = self.cfg
        B, T = self.B_d, self.T if self.shape.kind != "decode" else 1
        mx = self.model_ax
        kinds = cfg.layer_kinds()
        f = 0.0
        # per-layer projections + mixers
        for k in kinds:
            if k in ("global", "local"):
                H, K, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                               cfg.d_model)
                H_s, K_s = _shards(H, mx), _shards(K, mx)
                f += 2.0 * B * T * D * (H * hd / H_s + 2 * K * hd / K_s
                                        + H * hd / H_s)
                if self.shape.kind == "decode":
                    S = self.shape.seq_len if k == "global" else \
                        min(cfg.local_window, self.shape.seq_len)
                    S_d = S / _shards(S, mx)   # cache seq-sharded
                    f += 4.0 * B * (H / 1) * S_d * hd
                else:
                    f += self.attn_layer_flops_dev(
                        None if k == "global" else cfg.local_window)
            elif k == "ssd":
                D, din, N, Hh = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                 cfg.ssm_heads)
                proj = 2 * din + 2 * N + Hh
                f += 2.0 * B * T * D * (proj + din) / _shards(din, mx)
                if self.shape.kind == "decode":
                    f += 6.0 * B * Hh * cfg.ssm_head_dim * N / _shards(din, mx)
                else:
                    f += self.ssd_layer_flops_dev()
            elif k == "rglru":
                D, W = cfg.d_model, cfg.lru_width or cfg.d_model
                W_s = _shards(W, mx)
                f += 2.0 * B * T * (3.0 * D * W / W_s + 2.0 * W * W / W_s)
            if cfg.d_ff and k != "ssd":
                D, F = cfg.d_model, cfg.d_ff
                if cfg.num_experts:
                    # top-k active experts per token (+ router)
                    f += 2.0 * B * T * D * cfg.num_experts / _shards(
                        cfg.num_experts, mx)
                    cap = cfg.top_k * cfg.capacity_factor
                    eff = max(_shards(cfg.num_experts, mx), _shards(F, mx))
                    f += 6.0 * B * T * D * F * cap / eff
                else:
                    f += 6.0 * B * T * D * F / _shards(F, mx)
        # embed (gather ~ free) + unembed matmul
        V = cfg.vocab_size
        if self.shape.kind == "train":
            f += 2.0 * B * T * cfg.d_model * V / _shards(V, self.model_ax)
        else:
            Tl = 1  # prefill emits last-position logits only; decode T=1
            f += 2.0 * B * Tl * cfg.d_model * V / _shards(V, self.model_ax)
        return f * self.mult
