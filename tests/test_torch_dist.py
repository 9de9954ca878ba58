"""The port's distribution on 4 CPU ranks (gloo), held against the JAX
package under the same mesh shapes on 4 host devices.

One spawn of 4 torch ranks (rendezvous through a ``FileStore`` under
``tmp_path``, joined with a deadline, so a hung rank fails the test) runs
every case on ``(data=2, model=2)`` and ``(data=1, model=4)`` meshes, plus
``(pod=2, data=2, model=1)`` for ``cross_pod_mean``; one JAX subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) runs the
reference on meshes of the same shapes. Both read the same inputs, written
here: the smoke params of qwen3, recurrentgemma (MQA: 4 q heads, 1 kv
head), granite (MoE, G = 2 routing groups on the 2 x 2 mesh) and mamba2,
prompts, decode tokens, the trainer's initial checkpoint and the pods'
gradients.

Tolerances: model outputs and caches atol = rtol = 1e-4, float32 (the
smoke-parity tolerance of ``test_torch_model.py``: matmul summation order
differs between the frameworks, and under a mesh also between the ranks'
partial sums); trainer losses rtol 1e-4 (``test_torch_trainer.py``'s
carried-across tolerance); ``cross_pod_mean`` atol 1e-6 (one float32
product of exact integer sums).
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("qwen3-1.7b", "recurrentgemma-9b", "granite-moe-3b-a800m", "mamba2-370m")
MESHES = {"2x2": 2, "1x4": 4}  # name -> model_parallel over 4 ranks
WORLD = 4
B, T, L = 4, 24, 32  # batch, prompt, cache capacity
DECODE_STEPS = 2
TOL = dict(atol=1e-4, rtol=1e-4)
JOIN_S = 420.0
ADAMW = dict(peak_lr=3e-3, warmup_steps=2, total_steps=100)
TRAIN = dict(seq_len=32, global_batch=4, total_steps=4, checkpoint_every=100)


# ---------------------------------------------------------------------------
# the torch ranks
# ---------------------------------------------------------------------------
def _params(cfg, inp):
    """The reference's params (saved under their keystr paths) as the
    port's tree."""
    from repro_torch.models import model as M
    from repro_torch.models.params import ParamDef
    from repro_torch.models.tree import tree_map_with_path
    return tree_map_with_path(lambda path, d: torch.from_numpy(np.array(inp[path])),
                              M.param_defs(cfg),
                              is_leaf=lambda x: isinstance(x, ParamDef))


def _serve(cfg, params, mesh, inp, seen):
    """Prefill + DECODE_STEPS decode steps under ``mesh``: full logits and
    caches, and whether every cache kept its local storage."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.models.tree import tree_leaves
    from repro_torch.serving import pad_cache

    def ptrs(c):
        return [t.to_local().data_ptr() for t in tree_leaves(c)]

    rp, rd = shd.rules_for("prefill"), shd.rules_for("decode")
    p = M.distribute_params(params, M.param_defs(cfg), rp, mesh)
    plain = fa.flash_attention_plain

    def recording(q, k, v, **kw):
        seen.add((tuple(q.shape), tuple(k.shape)))
        return plain(q, k, v, **kw)
    fa.flash_attention_plain = recording
    try:
        with torch.no_grad():
            with shd.use_sharding(mesh, rp):
                logits, caches = M.prefill(cfg, p, {"tokens": torch.from_numpy(
                    inp["tokens"])})
                caches = pad_cache(caches, L, T, cfg=cfg)
            before = ptrs(caches)
            outs = [shd.full(logits).numpy()]
            with shd.use_sharding(mesh, rd):
                for i in range(DECODE_STEPS):
                    tok = torch.from_numpy(inp["decode"][i])
                    logits, caches = M.decode_step(cfg, p, tok, caches, T + i)
                    outs.append(shd.full(logits).numpy())
            in_place = ptrs(caches) == before
    finally:
        fa.flash_attention_plain = plain
    return {"logits": outs, "caches": [shd.full(t).numpy() for t in
                                       tree_leaves(caches)],
            "in_place": in_place}


def _models(rank, work, out):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    for mname, mp_ in MESHES.items():
        mesh = make_host_mesh(mp_, device="cpu")
        for arch in ARCHS:
            cfg = smoke_config(arch)
            inp = np.load(os.path.join(work, f"{arch}.npz"))
            params = _params(cfg, inp)
            for up in (False, True):
                seen = set()
                out[(mname, arch, up)] = _serve(cfg.replace(use_pallas=up), params,
                                                mesh, inp, seen)
                out[(mname, arch, up)]["attn_shapes"] = sorted(seen)
        with shd.use_sharding(mesh, shd.rules_for("prefill")):
            out[(mname, "groups")] = layers._batch_groups(B * T)
            # a cache laid out otherwise than the decode step writes it
            # (here: replicated) is refused, not silently copied
            k = torch.zeros((B, L, 2, 16))
            try:
                shd.shard_in_place(shd.as_dtensor(k, mesh), "batch", "cache_seq",
                                   "act_kv", None)
                out[(mname, "refused")] = False
            except ValueError:
                out[(mname, "refused")] = True


def _trainer(rank, work, out):
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.tree import tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    ckpt = os.path.join(work, f"port_ckpt{rank}")
    shutil.copytree(os.path.join(work, "init_ckpt"), ckpt)
    tc = TrainerConfig(**TRAIN, checkpoint_dir=ckpt, adamw=AdamWConfig(**ADAMW))
    tr = Trainer(smoke_config("qwen3-1.7b"), tc, mesh=make_host_mesh(2, device="cpu"))
    tr.run(2)
    before = [t.full_tensor().clone() for t in tree_leaves(tr.params)]
    count = int(tr.opt_state["count"])
    tr.remesh(make_host_mesh(1, device="cpu"))
    after = [t.full_tensor() for t in tree_leaves(tr.params)]
    out["remesh_same"] = all(torch.equal(a, b) for a, b in zip(before, after))
    out["remesh_count"] = (count, int(tr.opt_state["count"]))
    out["remesh_placements"] = [str(t.placements) for t in tree_leaves(tr.params)[:1]]
    log = tr.run(2)
    out["losses"] = [m["loss"] for m in log]


def _cross_pod(rank, work, out):
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.optim.compress import cross_pod_mean
    mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2, 1),
                      mesh_dim_names=("pod", "data", "model"))
    inp = np.load(os.path.join(work, "xpod.npz"))
    pod = rank // 2
    mean, res = cross_pod_mean(torch.from_numpy(inp["grad"][pod]),
                               torch.from_numpy(inp["res"][pod]), mesh)
    out["xpod"] = (pod, mean.numpy(), res.numpy())


def _rank(rank, store, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    out = {}
    try:
        _models(rank, work, out)
        _trainer(rank, work, out)
        _cross_pod(rank, work, out)
    finally:
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference, in a subprocess with 4 host devices
# ---------------------------------------------------------------------------
JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(sys.argv[2], "src"))
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.core  # noqa: F401  (the reference's import order)
from repro.configs.registry import smoke_config
from repro.dist import sharding as shd
from repro.models import model as M
from repro.optim import AdamWConfig
from repro.optim.compress import cross_pod_mean
from repro.serving import pad_cache
from repro.train import Trainer, TrainerConfig

work, T, L, steps = sys.argv[1], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
archs = sys.argv[6].split(",")
devs = np.array(jax.devices())
assert len(devs) == 4, devs
meshes = {"2x2": Mesh(devs.reshape(2, 2), ("data", "model")),
          "1x4": Mesh(devs.reshape(1, 4), ("data", "model"))}
out = {}
for arch in archs:
    cfg = smoke_config(arch)
    inp = np.load(os.path.join(work, arch + ".npz"))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(inp[jax.tree_util.keystr(path)]),
        M.init_params(cfg, jax.random.PRNGKey(0)))
    for name, mesh in meshes.items():
        rep = NamedSharding(mesh, P())
        p = jax.device_put(params, rep)
        rp, rd = shd.rules_for("prefill"), shd.rules_for("decode")

        def pre(p, b, mesh=mesh, rp=rp, cfg=cfg):
            with shd.use_sharding(mesh, rp):
                return M.prefill(cfg, p, b)

        def dec(p, t, c, i, mesh=mesh, rd=rd, cfg=cfg):
            with shd.use_sharding(mesh, rd):
                return M.decode_step(cfg, p, t, c, i)
        lg, c = jax.jit(pre)(p, {"tokens": jax.device_put(inp["tokens"], rep)})
        c = pad_cache(c, L, T, cfg)
        lgs = [lg]
        for i in range(steps):
            lg, c = jax.jit(dec)(p, jax.device_put(inp["decode"][i], rep), c,
                                 jnp.int32(T + i))
            lgs.append(lg)
        for j, x in enumerate(lgs):
            out["%s/%s/logits%d" % (name, arch, j)] = np.asarray(x)
        for j, x in enumerate(jax.tree_util.tree_leaves(c)):
            out["%s/%s/cache%d" % (name, arch, j)] = np.asarray(x)

# the trainer: 2 steps on (2, 2), re-mesh onto (4, 1), 2 more. Its
# init_state draws the params of the initial checkpoint (the same seed);
# restoring that checkpoint here would commit "count" to one device, which
# the reference's jitted step then refuses beside the meshed params
ckpt = os.path.join(work, "jax_ckpt")
tc = TrainerConfig(seq_len=32, global_batch=4, total_steps=4, checkpoint_every=100,
                   checkpoint_dir=ckpt,
                   adamw=AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=100))
tr = Trainer(smoke_config("qwen3-1.7b"), tc, mesh=meshes["2x2"],
             rules=shd.train_rules())
tr.run(2)
tr.remesh(Mesh(devs.reshape(4, 1), ("data", "model")), shd.train_rules())
out["losses"] = np.asarray([m["loss"] for m in tr.run(2)])

# cross_pod_mean inside shard_map over the pod axis
pod_mesh = Mesh(devs.reshape(2, 2, 1), ("pod", "data", "model"))
x = np.load(os.path.join(work, "xpod.npz"))


def per_pod(g, r):
    m, nr = cross_pod_mean(g[0], r[0], "pod")
    return m[None], nr[None]


mean, res = jax.shard_map(per_pod, mesh=pod_mesh, in_specs=(P("pod"), P("pod")),
                          out_specs=(P("pod"), P("pod")), check_vma=False)(
    jnp.asarray(x["grad"]), jnp.asarray(x["res"]))
out["xpod_mean"], out["xpod_res"] = np.asarray(mean), np.asarray(res)
np.savez(os.path.join(work, "jax.npz"), **out)
"""


def _inputs(work):
    """Params (the JAX package's init), prompts and decode tokens per arch;
    the trainer's initial checkpoint; the pods' gradients of unequal
    scale."""
    import jax
    from repro.configs.registry import smoke_config as jsmoke
    from repro.models import model as JM
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train import Trainer as JTrainer
    from repro.train import TrainerConfig as JTrainerConfig
    rng = np.random.default_rng(7)
    for arch in ARCHS:
        cfg = jsmoke(arch)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            JM.init_params(cfg, jax.random.PRNGKey(0)))
        np.savez(os.path.join(work, f"{arch}.npz"),
                 tokens=rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32),
                 decode=rng.integers(1, cfg.vocab_size, (DECODE_STEPS, B, 1)
                                     ).astype(np.int32),
                 **{jax.tree_util.keystr(k): np.asarray(x) for k, x in flat})
    tc = JTrainerConfig(**TRAIN, checkpoint_dir=os.path.join(work, "init_ckpt"),
                        adamw=JAdamWConfig(**ADAMW))
    tr = JTrainer(jsmoke("qwen3-1.7b"), tc).init_state()
    tr.ckpt.save(0, {"params": tr.params, "opt": tr.opt_state}, blocking=True)
    # pod 0's values are ~1, pod 1's ~100: their int8 scales differ 100x
    grad = np.stack([rng.standard_normal(64), 100 * rng.standard_normal(64)])
    np.savez(os.path.join(work, "xpod.npz"), grad=grad.astype(np.float32),
             res=np.zeros_like(grad, np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({rank: results}, the reference's results, the work dir), computed
    once."""
    work = str(tmp_path_factory.mktemp("dist"))
    _inputs(work)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, work, ROOT, str(T), str(L),
         str(DECODE_STEPS), ",".join(ARCHS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    ctx = mp.start_processes(_rank, args=(os.path.join(work, "store"), work),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"gloo ranks still running after {JOIN_S} s")
        log, _ = ref.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log.decode()[-4000:]
    ranks = {r: torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)}
    return ranks, dict(np.load(os.path.join(work, "jax.npz"))), work


CASES = [(m, a, up) for m in MESHES for a in ARCHS for up in (False, True)]


@pytest.mark.parametrize("mesh,arch,use_pallas", CASES,
                         ids=[f"{m}-{a}-{'kernel' if up else 'plain'}"
                              for m, a, up in CASES])
def test_prefill_decode_match_reference_under_mesh(runs, mesh, arch, use_pallas):
    """Prefill logits, each decode step's logits and the final caches, on
    every rank, equal the reference's under the same mesh shape."""
    ranks, ref, _ = runs
    for r, res in ranks.items():
        got = res[(mesh, arch, use_pallas)]
        for j, lg in enumerate(got["logits"]):
            np.testing.assert_allclose(lg, ref[f"{mesh}/{arch}/logits{j}"], **TOL,
                                       err_msg=f"rank {r} logits {j}")
        assert len(got["caches"]) == sum(k.startswith(f"{mesh}/{arch}/cache")
                                         for k in ref)
        for j, c in enumerate(got["caches"]):
            np.testing.assert_allclose(c, ref[f"{mesh}/{arch}/cache{j}"], **TOL,
                                       err_msg=f"rank {r} cache {j}")


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES for a in ARCHS])
def test_decode_caches_stay_in_their_storage(runs, mesh, arch):
    """Each decode step writes its KV (or conv window and state) into the
    ranks' own shards, in place: the local storages do not change."""
    for res in runs[0].values():
        for up in (False, True):
            assert res[(mesh, arch, up)]["in_place"]


def test_moe_groups_follow_the_mesh(runs):
    """granite routes in G = 2 groups on (2, 2) (batch over data = 2), one
    on (1, 4), as the reference's ``_batch_groups``."""
    for res in runs[0].values():
        assert res[("2x2", "groups")] == 2
        assert res[("1x4", "groups")] == 1


def test_attention_runs_on_local_shards_where_the_heads_line_up(runs):
    """The kernel path's attention on local shards: qwen3 (4 q, 2 kv heads)
    splits both by 2 on (2, 2), and by batch over data; on (1, 4) its 2 kv
    heads cannot split 4 ways and every head is replicated first;
    recurrentgemma's one kv head is replicated, and so are its q heads
    (a naive split would map local q head i to kv head i // (H_local / K))."""
    for res in runs[0].values():
        q22 = res[("2x2", "qwen3-1.7b", True)]["attn_shapes"]
        assert q22 == [((B // 2, T, 2, 16), (B // 2, T, 1, 16))], q22
        q14 = res[("1x4", "qwen3-1.7b", True)]["attn_shapes"]
        assert q14 == [((B, T, 4, 16), (B, T, 2, 16))], q14
        for m, b in (("2x2", B // 2), ("1x4", B)):
            rg = res[(m, "recurrentgemma-9b", True)]["attn_shapes"]
            assert {s[0][0] for s in rg} == {b} and {s[0][2] for s in rg} == {4}, rg
        for m in MESHES:
            assert res[(m, "qwen3-1.7b", False)]["attn_shapes"] == []


def test_shard_in_place_refuses_a_cache_it_would_move(runs):
    for res in runs[0].values():
        assert res[("2x2", "refused")] and res[("1x4", "refused")]


def test_trainer_remesh_matches_reference(runs):
    """Trainer 2 steps on (2, 2), ``remesh`` onto (4, 1), 2 more, from the
    reference's initial checkpoint: the losses equal the reference's
    trainer's through the same re-mesh; the params are bit-identical
    across the re-mesh and ``count`` is kept."""
    ranks, ref, _ = runs
    for res in ranks.values():
        assert res["remesh_same"]
        assert res["remesh_count"] == (2, 2)
        # the first leaf, ffn w_down (layers, ff, embed): embed over data = 4
        assert res["remesh_placements"] == ["(Shard(dim=2), Replicate())"]
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-4)


def test_cross_pod_mean_matches_reference_and_pins_caveat_10(runs):
    """Each pod's ``cross_pod_mean`` equals the reference's under
    ``shard_map``. The pods' int8 scales differ 100x, and both packages
    dequantize the summed payloads with the larger one: pod 0's term is
    multiplied by ~100, so the result is far from the true mean (ROADMAP,
    reference caveat 10)."""
    ranks, ref, work = runs
    grad = np.load(os.path.join(work, "xpod.npz"))["grad"]
    scale = np.abs(grad).max(axis=1, keepdims=True) / 127.0
    q = np.clip(np.round(grad / scale), -127, 127)
    caveat = q.sum(0) * scale.max() / 2  # the packages' arithmetic
    true = grad.mean(0)
    for r, res in ranks.items():
        pod, mean, new_res = res["xpod"]
        assert pod == r // 2
        np.testing.assert_allclose(mean, ref["xpod_mean"][pod], atol=1e-6)
        np.testing.assert_allclose(new_res, ref["xpod_res"][pod], atol=1e-6)
        np.testing.assert_allclose(mean, caveat, rtol=1e-5, atol=1e-4)
        assert np.abs(mean - true).max() > 0.3 * np.abs(true).max()
