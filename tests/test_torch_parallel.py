"""The port's mesh, sharding rules and collectives against the JAX
package's ``parallel/``.

Rank layouts and collectives run in a gang of gloo processes on the CPU
(``test_torch_tp.run_gang``); rules and slices need no processes: a rank's
slices are cut from its coordinates, so a stand-in for the device mesh
that answers ``get_local_rank`` gives each rank's exact slices, which are
held to ``x.addressable_shards`` of the same leaf placed by JAX on a
``tensor=2`` mesh of this process's virtual CPU devices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import parallel as jax_parallel
from skypilot_tpu.models import generate as jax_gen
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import quantization as jax_quant
from skypilot_tpu.parallel import collectives as jax_coll
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.parallel import sharding as jax_sharding
from skypilot_tpu_torch import parallel as port_parallel
from skypilot_tpu_torch.models import llama as port_llama
from skypilot_tpu_torch.models import quantization as port_quant
from skypilot_tpu_torch.parallel import collectives as port_coll
from skypilot_tpu_torch.parallel import mesh as port_mesh
from skypilot_tpu_torch.parallel import sharding as port_sharding
from test_torch_tp import run_gang


@pytest.mark.parametrize('spec,n', [
    (dict(), 1), (dict(), 8), (dict(fsdp=1, tensor=2), 2),
    (dict(data=2, fsdp=-1, tensor=2), 8), (dict(fsdp=2, expert=4), 8),
    (dict(fsdp=-1, tensor=-1), 4), (dict(fsdp=1, tensor=3), 4),
    (dict(fsdp=3), 8)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    def resolve(lib):
        try:
            return lib.MeshSpec(**spec).resolve(n)
        except ValueError as exc:
            return f'ValueError: {exc}'
    assert resolve(port_mesh) == resolve(jax_mesh)


def test_build_mesh_one_process_is_the_one_device_mesh():
    mesh = port_mesh.build_mesh(device='cpu')
    single = port_mesh.single_device_mesh('cpu')
    want = {a: 1 for a in jax_mesh.AXIS_ORDER}
    assert mesh.shape == single.shape == want
    assert mesh.axis_names == jax_mesh.AXIS_ORDER
    assert mesh.size == 1 and mesh.backend is None
    for axis in mesh.axis_names:
        assert mesh.group(axis) is None and mesh.axis_index(axis) == 0
    # The DCN rule, in JAX's words.
    with pytest.raises(ValueError) as port_err:
        port_mesh.build_mesh(num_slices=2, device='cpu')
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.build_mesh(devices=jax.devices()[:1], num_slices=2)
    assert str(port_err.value) == str(jax_err.value)


def test_parallel_exports_are_jaxs():
    assert port_parallel.__all__ == jax_parallel.__all__


_GANG_BODY = '''
from skypilot_tpu_torch.parallel import collectives
layouts = {}
for name, kw in inputs['meshes'].items():
    kw = dict(kw)
    slices = kw.pop('num_slices', 1)
    m = mesh_lib.build_mesh(mesh_lib.MeshSpec(**kw), num_slices=slices,
                            device='cpu')
    layouts[name] = {'shape': m.shape, 'backend': m.backend,
                     'coords': {a: m.axis_index(a) for a in m.axis_names},
                     'verify': collectives.verify_collectives(m),
                     'bench': collectives.allreduce_benchmark(
                         1.0, m, 'tensor', iters=2)}
out['layouts'] = layouts
'''
MESHES = {'tensor4': dict(fsdp=1, tensor=4),
          'dcn': dict(data=2, fsdp=1, tensor=2, num_slices=2)}


@pytest.fixture(scope='module')
def gang4(tmp_path_factory):
    return run_gang(tmp_path_factory.mktemp('mesh_gang'), 4, _GANG_BODY,
                    spec={'fsdp': 4}, inputs={'meshes': MESHES})


@pytest.mark.parametrize('name', sorted(MESHES))
def test_build_mesh_rank_layout_matches_jax(gang4, name):
    """Each rank's coordinates are those of the device with its index in
    JAX's mesh over 4 devices (with ``num_slices=2``, contiguous blocks of
    ranks per slice and ``data`` outermost)."""
    kw = dict(MESHES[name])
    slices = kw.pop('num_slices', 1)
    jm = jax_mesh.build_mesh(jax_mesh.MeshSpec(**kw),
                             devices=jax.devices()[:4], num_slices=slices)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, out in enumerate(gang4):
        lay = out['layouts'][name]
        assert lay['shape'] == dict(jm.shape)
        assert lay['backend'] == 'gloo'
        where = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        assert tuple(lay['coords'][a] for a in jm.axis_names) == where


@pytest.mark.parametrize('name', sorted(MESHES))
def test_verify_collectives_on_each_axis(gang4, name):
    """Sum, all-gather and ring permute hold JAX's expected values on every
    axis larger than 1, on every rank."""
    axes = {a for a, n in gang4[0]['layouts'][name]['shape'].items()
            if n > 1}
    for out in gang4:
        assert out['layouts'][name]['verify'] == {a: True for a in axes}


def test_allreduce_benchmark_keys_are_jaxs(gang4):
    """nccl-tests' accounting under JAX's keys, and the single-rank answer
    word for word."""
    jm = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1, tensor=2),
                             devices=jax.devices()[:2])
    want = jax_coll.allreduce_benchmark(1.0, jm, 'tensor', iters=2)
    for out in gang4:
        got = out['layouts']['tensor4']['bench']
        assert set(got) == set(want)
        assert got['ranks'] == 4 and got['busbw_gbps'] == pytest.approx(
            got['algbw_gbps'] * 2 * 3 / 4)
    one_jax = jax_coll.allreduce_benchmark(
        1.0, jax_mesh.single_device_mesh(), 'tensor')
    one_port = port_coll.allreduce_benchmark(
        1.0, port_mesh.single_device_mesh('cpu'), 'tensor')
    assert one_port == one_jax


# -- rules -------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, tuple):
        return [tree]
    return [la for v in tree.values() for la in _leaves(v)]


def _logical_tuples():
    cfg = jax_llama.TINY
    trees = [jax_llama.param_logical_axes(cfg),
             jax_quant._axes_tree(cfg, lambda scope, name: True)]  # noqa: SLF001
    out = {la for t in trees for la in _leaves(t)}
    out.add(('layers', 'batch', 'kv_heads', None, 'head_dim'))
    out.add(('layers', 'batch', 'kv_heads', None))
    out.add(('batch',))
    for la in (('batch', 'heads', None), ('batch', 'kv_heads', None, None),
               ('batch', 'kv_heads', None), ('embed', 'embed', 'mlp'),
               ('batch', 'seqlen', 'act_embed'), ('vocab', 'mlp')):
        out.add(la)
    return sorted(out, key=repr)


@pytest.mark.parametrize('logical', _logical_tuples(), ids=repr)
def test_rules_mesh_axes_match_jax(logical):
    """Every logical tuple the llama, quantization and decode-kernel paths
    use maps to JAX's spec (one mesh axis never on two dims)."""
    want = tuple(jax_sharding.ShardingRules().mesh_axes(logical))
    assert port_sharding.ShardingRules().mesh_axes(logical) == want


def test_port_axes_trees_are_jaxs():
    cfg = port_llama.TINY
    jcfg = jax_llama.TINY
    assert port_llama.param_logical_axes(cfg) == \
        jax_llama.param_logical_axes(jcfg)
    for pred in (lambda scope, name: True,
                 lambda scope, name: name in ('wq', 'w_down')):
        assert port_quant._axes_tree(cfg, pred) == \
            jax_quant._axes_tree(jcfg, pred)  # noqa: SLF001


def test_constrain_is_a_no_op_and_specs_are_tuples():
    mesh = port_mesh.single_device_mesh('cpu')
    rules = port_sharding.ShardingRules()
    x = torch.ones(2, 3)
    assert port_sharding.constrain(x, mesh, rules, ('batch', None)) is x
    sh = port_sharding.logical_sharding(mesh, rules, ('embed', 'vocab'))
    assert sh.spec == ('fsdp', 'tensor') and sh.mesh is mesh


# -- slices against JAX's addressable shards ----------------------------------


class _Coords:
    """The one question a mesh's slicing asks of its device mesh."""

    def __init__(self, coords):
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


def _rank_mesh(tp, rank):
    sizes = {a: 1 for a in port_mesh.AXIS_ORDER}
    sizes['tensor'] = tp
    return port_mesh.Mesh(sizes, torch.device('cpu'),
                          _Coords({'tensor': rank}), 'gloo')


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f'{prefix}{k}/').items()}
    return {prefix.rstrip('/'): tree}


@pytest.mark.parametrize('kind', ['bf16', 'int8'])
def test_shard_params_slices_equal_jax_addressable_shards(kind):
    """Each rank's slice of every leaf equals the shard JAX's
    ``shard_params`` placed on the device at its tensor index."""
    jp = jax_llama.init_params(jax.random.PRNGKey(0), jax_llama.TINY)
    if kind == 'int8':
        jp = jax_quant.quantize_params(jp)
    jm = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1, tensor=2),
                             devices=jax.devices()[:2])
    placed = _flat(jax_quant.shard_params(jp, jax_llama.TINY, jm))
    tree = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)
                             if a.dtype == jnp.bfloat16 else a), jp)
    full = port_llama.params_from_numpy(tree, port_llama.TINY, 'cpu')
    tensor_index = {d.id: i for i, d in enumerate(jm.devices.flat)}
    for rank in range(2):
        mine = _flat(port_quant.shard_params(full, port_llama.TINY,
                                             _rank_mesh(2, rank)))
        assert set(mine) == set(placed)
        for name, arr in placed.items():
            shard = next(s for s in arr.addressable_shards
                         if tensor_index[s.device.id] == rank)
            want = np.asarray(shard.data.astype(jnp.float32)
                              if shard.data.dtype == jnp.bfloat16
                              else shard.data)
            got = mine[name]
            assert tuple(got.shape) == want.shape, name
            np.testing.assert_array_equal(got.float().numpy()
                                          if got.is_floating_point()
                                          else got.numpy(), want,
                                          err_msg=name)


def test_kv_cache_born_sharded_shape_is_jaxs():
    """``init_cache(..., mesh=)`` holds this rank's kv heads: the shape of
    JAX's addressable shard of a cache placed with the engine's spec."""
    cfg = dataclasses.replace(port_llama.TINY, dtype=torch.float32)
    from skypilot_tpu_torch.models import generate as port_gen
    cache = port_gen.init_cache(cfg, 4, 32, device='cpu',
                                mesh=_rank_mesh(2, 1), quantize=True)
    jm = jax_mesh.build_mesh(jax_mesh.MeshSpec(fsdp=1, tensor=2),
                             devices=jax.devices()[:2])
    rules = jax_sharding.ShardingRules()
    jc = jax_gen.init_cache(
        jax_llama.TINY, 4, 32, quantize=True,
        kv_sharding=jax_sharding.logical_sharding(
            jm, rules, ('layers', 'batch', 'kv_heads', None, 'head_dim')),
        kv_scale_sharding=jax_sharding.logical_sharding(
            jm, rules, ('layers', 'batch', 'kv_heads', None)))
    assert tuple(cache.k.shape) == jc.k.addressable_shards[0].data.shape
    assert tuple(cache.k_s.shape) == \
        jc.k_s.addressable_shards[0].data.shape
