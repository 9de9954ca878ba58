"""The port's sharding rules and ambient context (``repro_torch.dist``): the
reference's ``tests/test_sharding.py`` and ``tests/test_dist_context.py``
re-pointed, each resolution held equal to the JAX package's on the same
fake meshes (hypothesis shapes too), plus what the port adds: DTensor
placements, ``mesh_shape`` of a real ``DeviceMesh``, ``bind_sharding`` on
a mesh whose ``.shape`` is a tuple of sizes, the one-rank host mesh, and
the TensorSpecs of a meshed cell.
"""
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

from repro.core.platform import Platform as JPlatform
from repro.core.platform import bind_sharding as jbind
from repro.dist import sharding as jshd
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core.platform import Platform, bind_sharding
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import PartitionSpec as P
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


class NamedMesh:
    """What ``placements_for`` and ``bind_sharding`` read of a
    ``DeviceMesh``: dim names, a ``.shape`` of sizes, ``size(j)``."""

    def __init__(self, names, sizes):
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(sizes)

    def size(self, j):
        return self.shape[j]


MESH = FakeMesh({"data": 16, "model": 16})
MESH_MP = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESH_A = FakeMesh({"data": 4, "model": 2})
MESH_B = FakeMesh({"data": 2, "model": 4})


def both(shape, axes, kind="train", mesh=MESH, **kw):
    """The port's spec, asserted equal to the reference's."""
    got = shd.pspec_for(shape, axes, getattr(shd, f"{kind}_rules")(**kw), mesh)
    want = jshd.pspec_for(shape, axes, getattr(jshd, f"{kind}_rules")(**kw), mesh)
    assert got == want and tuple(got) == tuple(want), (got, want)
    return got


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group for the test, destroyed after it (the host
    mesh starts it where none exists)."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


# -- tests/test_sharding.py, re-pointed -----------------------------------------
def test_divisibility_fallback():
    assert both((3072, 24, 128), ("embed", "heads", "head_dim")) == JP(
        "data", None, None)
    assert both((5120, 64, 128), ("embed", "heads", "head_dim")) == JP("data", "model",
                                                                       None)


def test_axis_never_used_twice():
    spec = both((16, 4096, 16, 128), ("batch", "cache_seq", "act_kv", None))
    assert spec == P("data", "model", None, None)


def test_multipod_batch_axes():
    spec = both((256, 4096), ("batch", "seq"), mesh=MESH_MP, multi_pod=True)
    assert spec == P(("pod", "data"), None)


def test_seq_shard_attn_lever():
    shape, axes = (16, 4096, 24, 128), ("batch", "attn_seq", "act_heads", None)
    assert both(shape, axes, seq_shard_attn=True) == P("data", "model", None, None)
    assert both(shape, axes, seq_shard_attn=False) == P("data", None, None, None)


dims = st.integers(1, 8).map(lambda k: 2 ** k)


@given(st.lists(dims, min_size=1, max_size=4), st.integers(0, 1))
@settings(max_examples=50, deadline=None)
def test_pspec_always_valid_and_equal_to_reference(shape, which):
    names = ["batch", "seq", "act_heads", "embed", "ff", "vocab", "expert", None]
    axes = tuple(names[i % len(names)] for i in range(len(shape)))
    spec = both(tuple(shape), axes, "train" if which else "decode")
    used = []
    for dim, part in zip(shape, spec):
        if part is None:
            continue
        parts = (part,) if isinstance(part, str) else part
        for p in parts:
            assert p in MESH.shape and p not in used
            used.append(p)
        assert dim % int(np.prod([MESH.shape[p] for p in parts])) == 0


def test_shard_noop_outside_ctx():
    x = torch.ones((4, 4))
    assert shd.shard(x, "batch", None) is x


# -- tests/test_dist_context.py, re-pointed -------------------------------------
def test_default_is_empty():
    assert shd.current_sharding() == (None, None)


def test_nesting_restores_outer():
    ra, rb = shd.train_rules(), shd.decode_rules()
    with shd.use_sharding(MESH_A, ra):
        assert shd.current_sharding() == (MESH_A, ra)
        with shd.use_sharding(MESH_B, rb):
            assert shd.current_sharding() == (MESH_B, rb)
        assert shd.current_sharding() == (MESH_A, ra)
    assert shd.current_sharding() == (None, None)


def test_context_instance_is_reusable():
    ctx = shd.use_sharding(MESH_A, shd.train_rules())
    for _ in range(2):
        with ctx:
            assert shd.current_sharding()[0] is MESH_A
        assert shd.current_sharding() == (None, None)


def test_exception_unwinds_context():
    with pytest.raises(RuntimeError):
        with shd.use_sharding(MESH_A, shd.train_rules()):
            raise RuntimeError("boom")
    assert shd.current_sharding() == (None, None)


def test_thread_isolation():
    seen = {}
    ready, release = threading.Event(), threading.Event()

    def worker():
        seen["before"] = shd.current_sharding()
        with shd.use_sharding(MESH_B, shd.decode_rules()):
            seen["inside"] = shd.current_sharding()[0]
            ready.set()
            release.wait(5)
        seen["after"] = shd.current_sharding()

    with shd.use_sharding(MESH_A, shd.train_rules()):
        t = threading.Thread(target=worker)
        t.start()
        assert ready.wait(5)
        assert shd.current_sharding()[0] is MESH_A
        release.set()
        t.join(5)
    assert seen == {"before": (None, None), "inside": MESH_B, "after": (None, None)}


def test_shard_noop_outside_context():
    x = torch.ones((4, 8))
    assert shd.shard(x, "batch", "seq") is x
    assert shd.shard(x, "batch", None) is x


def test_shard_noop_with_partial_context():
    x = torch.ones((2, 2))
    with shd.use_sharding(None, shd.replicated_rules()):
        assert shd.shard(x, "batch", None) is x


def test_platform_rules_heterogeneous():
    edge = shd.rules_for_platform("edge")
    cloud = shd.rules_for_platform("cloud", "train")
    assert edge.lookup("batch") is None
    assert cloud.lookup("batch") == "data"
    assert shd.pspec_for((8, 16), ("batch", "seq"), edge, MESH_A) == P(None, None)
    assert shd.pspec_for((8, 16), ("batch", "seq"), cloud, MESH_A) == P("data", None)


def test_rules_replace_lever():
    rules = shd.train_rules().replace(embed=None)
    assert rules.lookup("embed") is None
    assert rules.lookup("ff") == "model"


# -- the port's own ---------------------------------------------------------------
@pytest.mark.parametrize("mesh", [MESH, MESH_MP, MESH_A],
                         ids=["pod", "multipod", "small"])
def test_validate_rules_and_describe_equal_reference(mesh):
    for kind in ("train", "decode"):
        mp = "pod" in mesh.shape
        rules = shd.rules_for(kind, multi_pod=mp)
        jrules = jshd.rules_for(kind, multi_pod=mp)
        assert shd.validate_rules(rules, mesh) == jshd.validate_rules(jrules, mesh)
        assert shd.describe(rules, mesh) == jshd.describe(jrules, mesh)


def test_placements_for_tuple_entries_and_size_one_dims():
    from torch.distributed.tensor import Replicate, Shard
    mp = NamedMesh(("pod", "data", "model"), (2, 16, 16))
    assert shd.placements_for(P(("pod", "data"), None, "model"), mp) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements_for(P(None, "data"), mp) == (Replicate(), Shard(1),
                                                       Replicate())
    # a mesh dim of size 1 holds the whole tensor: replicated either way
    one = NamedMesh(("data", "model"), (1, 4))
    assert shd.placements_for(P("data", "model"), one) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        shd.placements_for(P(("data", "pod")), mp)


def test_mesh_shape_of_device_mesh_and_fake_mesh(one_rank_group):
    mesh = make_host_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)  # a DeviceMesh's .shape: sizes only
    assert shd.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert shd.mesh_shape(MESH_MP) == {"pod": 2, "data": 16, "model": 16}
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1


def test_make_host_mesh_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()


def test_bind_sharding_picks_multi_pod_rules_on_a_pod_device_mesh():
    """``"pod" in mesh.shape`` is False for a DeviceMesh (its .shape is a
    tuple of sizes): the port reads ``mesh_shape`` and picks the multi-pod
    rules, as the reference does for its mesh."""
    mesh = NamedMesh(("pod", "data", "model"), (2, 16, 16))
    assert "pod" not in mesh.shape
    cloud = bind_sharding(Platform("c", "eu", device="cpu"), mesh=mesh)
    jcloud = jbind(JPlatform("c", "eu"), mesh=MESH_MP)
    assert cloud.rules.name == jcloud.rules.name == "decode_mp"
    assert cloud.rules.lookup("batch") == ("pod", "data")
    single = bind_sharding(Platform("s", "eu", device="cpu"),
                           mesh=NamedMesh(("data", "model"), (16, 16)),
                           workload="train")
    assert single.rules.name == "train"
    edge = bind_sharding(Platform("e", "eu", kind="edge", device="cpu"), mesh=mesh)
    assert edge.mesh is None and edge.rules.name == "replicated"


def test_shard_on_a_one_rank_mesh_keeps_values(one_rank_group):
    from torch.distributed.tensor import DTensor, Replicate
    mesh = make_host_mesh(device="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    with shd.use_sharding(mesh, shd.train_rules()):
        y = shd.shard(x, "batch", "act_ff")
        assert isinstance(y, DTensor) and y.placements == (Replicate(), Replicate())
        assert torch.equal(y.full_tensor(), x)
        # the cache path wraps in place: the same storage
        z = shd.shard_in_place(x, "batch", "act_ff")
        assert z.to_local().data_ptr() == x.data_ptr()


def test_input_specs_carry_mesh_and_placements(one_rank_group):
    from torch.distributed.tensor import Replicate
    mesh = make_host_mesh(device="cpu")
    cfg = get_config("qwen3-1.7b")
    rules = shd.rules_for("train")
    specs = M.input_specs(cfg, SHAPES["train_4k"], rules, mesh, device="cpu")
    assert set(specs) == {"tokens", "labels"}
    for s in specs.values():
        assert s.shape == (256, 4096) and s.mesh is mesh and s.device == "cpu"
        assert s.placements == (Replicate(), Replicate())
    assert M.spec_pspecs(M.batch_defs(cfg, SHAPES["train_4k"]), rules, MESH) == {
        "tokens": P("data", None), "labels": P("data", None)}
    dec = M.input_specs(cfg, SHAPES["decode_32k"], shd.rules_for("decode"), mesh,
                        device="cpu")
    assert dec["token"].shape == (128, 1)
    plain = M.input_specs(cfg, SHAPES["train_4k"], device="cpu")
    assert plain["tokens"].mesh is None and plain["tokens"].placements is None


def test_multi_pod_prefill_32k_batch_replicates_on_the_h100_mesh():
    """Fault 5, a deliberate difference: on the H100 multi-pod mesh (pod=2,
    data=32, model=8) the 32 sequences of prefill_32k do not divide over
    pod x data = 64, and the all-or-nothing rule replicates the batch (the
    reference's (2, 16, 16) mesh splits it 32 ways); on the single-pod H100
    mesh they split over data. The rule is the reference's."""
    from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD
    cfg = get_config("recurrentgemma-9b")
    defs = M.batch_defs(cfg, SHAPES["prefill_32k"])
    assert SHAPES["prefill_32k"].global_batch == 32
    h100_mp = FakeMesh(dict(zip(MULTI_POD[1], MULTI_POD[0])))
    h100_sp = FakeMesh(dict(zip(SINGLE_POD[1], SINGLE_POD[0])))
    mp_rules = shd.rules_for("prefill", multi_pod=True)
    assert M.spec_pspecs(defs, mp_rules, h100_mp) == {"tokens": P(None, None)}
    assert M.spec_pspecs(defs, shd.rules_for("prefill"), h100_sp) == {
        "tokens": P("data", None)}
    # the reference's mesh: the same rule splits the batch over pod x data
    assert M.spec_pspecs(defs, mp_rules, MESH_MP) == {
        "tokens": P(("pod", "data"), None)}
    jrules = jshd.rules_for("prefill", multi_pod=True)
    assert tuple(jshd.pspec_for((32, 32768), ("batch", "seq"), jrules,
                                FakeMesh(h100_mp.shape))) == (None, None)


def test_abstract_params_are_meta_dtensors(one_rank_group):
    """``abstract_params`` (the dry-run's inputs): meta tensors, and with
    rules and a mesh meta DTensors in the rules' placements; for SpecDefs
    each leaf's own dtype."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import params as prm
    from repro_torch.models.tree import tree_leaves
    cfg = get_config("qwen3-1.7b").replace(num_layers=2)
    mesh = make_host_mesh(device="cpu")
    rules = shd.rules_for("train")
    for leaf in tree_leaves(prm.abstract_params(M.param_defs(cfg), torch.bfloat16,
                                                rules, mesh)):
        assert isinstance(leaf, DTensor) and leaf.to_local().is_meta
        assert leaf.dtype == torch.bfloat16
    plain = prm.abstract_params(M.batch_defs(cfg, SHAPES["train_4k"]), None)
    assert plain["tokens"].is_meta and plain["tokens"].dtype == torch.int32
    assert prm.param_pspecs(M.param_defs(cfg), rules, MESH)["embed"] == P(
        "model", "data")
