"""Worker for the 2-process jax.distributed CPU test (test_multihost.py).

Run as: python multihost_worker.py <process_id> <num_processes> <port>

Exercises the REAL multi-process branches of parallel/multihost.py —
`union_vocab` (process_allgather vocab union) and `make_global_arrays`
(host-local shards -> global jax.Array) — plus a cross-process psum'd
cofactor aggregation, validated against the full-data sigma computed
locally (the data is deterministic so every process knows the whole
table)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from duckdb_imputation_tpu.parallel import multihost  # noqa: E402

multihost.initialize(f"127.0.0.1:{port}", nproc, proc_id)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc, jax.devices()

import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from duckdb_imputation_tpu import FeatureSchema  # noqa: E402
from duckdb_imputation_tpu.ring.sum import masked_sigma  # noqa: E402

# --- union_vocab: per-process vocabularies differ and have different sizes
local_keys = (((1, 2, 3), (10,)) if proc_id == 0
              else ((2, 3, 9), (10, 20, 30)))
merged = multihost.union_vocab(local_keys)
assert merged == ((1, 2, 3, 9), (10, 20, 30)), merged

# --- make_global_arrays + cross-process psum'd aggregation
schema = FeatureSchema(num_cols=2, cat_keys=((0, 1, 2),))
n_global = 64
rng = np.random.default_rng(0)  # same seed everywhere: all processes know
x_all = rng.normal(size=(2, n_global)).astype(np.float32)  # the full table
c_all = rng.integers(0, 3, size=(1, n_global)).astype(np.int32)
w_all = (rng.random(n_global) > 0.3).astype(np.float32)

lo = proc_id * (n_global // nproc)
hi = lo + n_global // nproc
mesh = multihost.global_mesh()
xg, cg, wg = multihost.make_global_arrays(
    mesh, x_all[:, lo:hi], c_all[:, lo:hi], w_all[lo:hi])
assert xg.shape == (2, n_global), xg.shape


@jax.jit
@functools.partial(shard_map, mesh=mesh,
                   in_specs=(P(None, "data"), P(None, "data"), P("data")),
                   out_specs=P())
def agg(x, c, w):
    return jax.lax.psum(masked_sigma(x, c, w, schema=schema), "data")


sigma = np.asarray(jax.block_until_ready(agg(xg, cg, wg)))
ref = np.asarray(masked_sigma(jnp.asarray(x_all), jnp.asarray(c_all),
                              jnp.asarray(w_all), schema=schema))
np.testing.assert_allclose(sigma, ref, rtol=1e-5, atol=1e-4)

# ---------------------------------------------------------------------------
# END-TO-END MICE across the 2 processes (round-3 verdict #4: the full loop
# had never crossed a process boundary). Every process knows the whole
# (deterministic) table; each contributes its row shard to the global mesh,
# runs the identical loop, and checks the result against a single-process
# run on a process-LOCAL 1-device mesh.
# ---------------------------------------------------------------------------
from jax.experimental import multihost_utils as mhu  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402

from duckdb_imputation_tpu.mice.partition import (build_partitions,  # noqa: E402
                                                  init_fill)
from duckdb_imputation_tpu.mice.sharded_round import (  # noqa: E402
    mice_loop_sharded, mice_loop_sharded_delta)
from duckdb_imputation_tpu.table import from_numpy  # noqa: E402

n2 = 128
ndev = len(jax.devices())
rng2 = np.random.default_rng(1)
z0 = rng2.normal(size=n2).astype(np.float32)
z1 = rng2.normal(size=n2).astype(np.float32)
num_all2 = np.stack([z0, 2 * z0 + z1,
                     rng2.normal(size=n2).astype(np.float32)])
cat_all2 = ((z0 > 0).astype(np.int32) * 3 + 4)[None, :]
nn_all = np.zeros((3, n2), bool)
cn_all = np.zeros((1, n2), bool)
nn_all[1, rng2.random(n2) < 0.25] = True
cn_all[0, rng2.random(n2) < 0.25] = True

t0 = init_fill(from_numpy(num_all2, cat_all2, nn_all, cn_all,
                          rows_first=False))
schema2 = t0.schema
x_f = np.asarray(t0.num_data)
c_f = np.asarray(t0.cat_codes)
valid_f = np.ones(n2, np.float32)

per = n2 // nproc
lo2 = proc_id * per


def _glob(a, spec):
    return mhu.host_local_array_to_global_array(
        np.ascontiguousarray(a[..., lo2:lo2 + per]), mesh, spec)


mice_kw = dict(schema=schema2, num_cols_to_impute=(1,),
               cat_cols_to_impute=(0,), iters=2, gd_iters=200,
               noise=False, trainer="solve", kernel="xla")
xg2 = _glob(x_f, P(None, "data"))
cg2 = _glob(c_f, P(None, "data"))
x_out, c_out = mice_loop_sharded(
    xg2, cg2, _glob(nn_all, P(None, "data")), _glob(cn_all, P(None, "data")),
    mhu.host_local_array_to_global_array(valid_f[lo2:lo2 + per], mesh,
                                         P("data")),
    jax.random.PRNGKey(7), mesh=mesh, **mice_kw)
x_loc = np.asarray(mhu.global_array_to_host_local_array(
    x_out, mesh, P(None, "data")))
c_loc = np.asarray(mhu.global_array_to_host_local_array(
    c_out, mesh, P(None, "data")))

# single-process ground truth on a process-local 1-device mesh
lmesh = Mesh(np.asarray(jax.local_devices()[:1]), ("data",))


def _lput(a, spec):
    return jax.device_put(a, NamedSharding(lmesh, spec))


x1, c1 = mice_loop_sharded(
    _lput(x_f, P(None, "data")), _lput(c_f, P(None, "data")),
    _lput(nn_all, P(None, "data")), _lput(cn_all, P(None, "data")),
    _lput(valid_f, P("data")), jax.random.PRNGKey(7), mesh=lmesh, **mice_kw)
np.testing.assert_allclose(x_loc, np.asarray(x1)[:, lo2:lo2 + per],
                           rtol=2e-3, atol=2e-3)
np.testing.assert_array_equal(c_loc, np.asarray(c1)[:, lo2:lo2 + per])

# --- the sharded DELTA loop (imputation_low.cpp:42-110 strategy) ---
parts = build_partitions(t0)
m_rows = n2 // ndev


def _shard_gathers(idx, nd):
    idx = np.asarray(idx, np.int64)
    per_s = [idx[(idx >= s * m_rows * (ndev // nd))
                 & (idx < (s + 1) * m_rows * (ndev // nd))]
             - s * m_rows * (ndev // nd) for s in range(nd)]
    width = max(max((len(p) for p in per_s), default=0), 1)
    width = 1 << (width - 1).bit_length()
    out_i = np.zeros((nd, width), np.int64)
    out_v = np.zeros((nd, width), np.float32)
    for s, p2 in enumerate(per_s):
        out_i[s, :len(p2)] = p2
        out_v[s, :len(p2)] = 1.0
    return out_i, out_v


def _globg(a):
    local = np.ascontiguousarray(a[proc_id * (ndev // nproc):
                                   (proc_id + 1) * (ndev // nproc)])
    return mhu.host_local_array_to_global_array(local, mesh, P("data", None))


# shard-local UNION of dirty rows (compact delta form)
union_all = np.unique(np.concatenate(
    [np.asarray(parts.num_dirty_idx[1], np.int64),
     np.asarray(parts.cat_dirty_idx[0], np.int64)]))
ugi, ugv = _shard_gathers(union_all, ndev)
xd, cd = mice_loop_sharded_delta(
    xg2, cg2, _glob(nn_all, P(None, "data")),
    _glob(cn_all, P(None, "data")),
    mhu.host_local_array_to_global_array(valid_f[lo2:lo2 + per], mesh,
                                         P("data")),
    jax.random.PRNGKey(7), _globg(ugi), _globg(ugv),
    mesh=mesh, **mice_kw)
xd_loc = np.asarray(mhu.global_array_to_host_local_array(
    xd, mesh, P(None, "data")))

ugi1, ugv1 = _shard_gathers(union_all, 1)
xd1, cd1 = mice_loop_sharded_delta(
    _lput(x_f, P(None, "data")), _lput(c_f, P(None, "data")),
    _lput(nn_all, P(None, "data")), _lput(cn_all, P(None, "data")),
    _lput(valid_f, P("data")), jax.random.PRNGKey(7),
    _lput(ugi1, P("data", None)), _lput(ugv1, P("data", None)),
    mesh=lmesh, **mice_kw)
np.testing.assert_allclose(xd_loc, np.asarray(xd1)[:, lo2:lo2 + per],
                           rtol=2e-3, atol=2e-3)

# --- round-boundary checkpoint/resume ACROSS PROCESSES (verdict r4 #6):
# rounds 0..1 run as two dispatches with round_offset, each process
# persisting its HOST-LOCAL shard between them (the multi-controller
# checkpoint pattern); the resumed trajectory must equal the
# single-dispatch 2-round run BIT-FOR-BIT (noise keys fold global rounds
# and global row indices).
import tempfile  # noqa: E402

noise_kw = dict(mice_kw, noise=True)
xa, ca = mice_loop_sharded(
    xg2, cg2, _glob(nn_all, P(None, "data")), _glob(cn_all, P(None, "data")),
    mhu.host_local_array_to_global_array(valid_f[lo2:lo2 + per], mesh,
                                         P("data")),
    jax.random.PRNGKey(7), mesh=mesh, iters=1, round_offset=0,
    **{k: v for k, v in noise_kw.items() if k != "iters"})
ck = os.path.join(tempfile.gettempdir(), f"mh_ckpt_{port}_{proc_id}.npz")
np.savez(ck,
         x=np.asarray(mhu.global_array_to_host_local_array(
             xa, mesh, P(None, "data"))),
         c=np.asarray(mhu.global_array_to_host_local_array(
             ca, mesh, P(None, "data"))))
zk = np.load(ck)          # "fresh process": reload the shard from disk
xb, cb = mice_loop_sharded(
    mhu.host_local_array_to_global_array(zk["x"], mesh, P(None, "data")),
    mhu.host_local_array_to_global_array(zk["c"], mesh, P(None, "data")),
    _glob(nn_all, P(None, "data")), _glob(cn_all, P(None, "data")),
    mhu.host_local_array_to_global_array(valid_f[lo2:lo2 + per], mesh,
                                         P("data")),
    jax.random.PRNGKey(7), mesh=mesh, iters=1, round_offset=1,
    **{k: v for k, v in noise_kw.items() if k != "iters"})
x2s, c2s = mice_loop_sharded(
    xg2, cg2, _glob(nn_all, P(None, "data")), _glob(cn_all, P(None, "data")),
    mhu.host_local_array_to_global_array(valid_f[lo2:lo2 + per], mesh,
                                         P("data")),
    jax.random.PRNGKey(7), mesh=mesh, iters=2,
    **{k: v for k, v in noise_kw.items() if k != "iters"})
np.testing.assert_array_equal(
    np.asarray(mhu.global_array_to_host_local_array(xb, mesh,
                                                    P(None, "data"))),
    np.asarray(mhu.global_array_to_host_local_array(x2s, mesh,
                                                    P(None, "data"))))
np.testing.assert_array_equal(
    np.asarray(mhu.global_array_to_host_local_array(cb, mesh,
                                                    P(None, "data"))),
    np.asarray(mhu.global_array_to_host_local_array(c2s, mesh,
                                                    P(None, "data"))))
os.remove(ck)

# --- the out-of-core streaming fold riding the cross-process mesh ---
from duckdb_imputation_tpu.mice.streaming import run_mice_stream  # noqa: E402
from duckdb_imputation_tpu.ring.streaming import chunks_from_arrays  # noqa: E402

raw_num = num_all2.copy()
raw_num[nn_all] = np.nan                    # nulls as NaN for the stream
src = chunks_from_arrays(raw_num, cat_all2, nn_all, cn_all, chunk_rows=48)
res_mesh = run_mice_stream(src, iters=2, noise=False, linreg_iters=200,
                           chunk_rows=32, mesh=mesh)
res_one = run_mice_stream(src, iters=2, noise=False, linreg_iters=200,
                          chunk_rows=32)
np.testing.assert_allclose(np.asarray(res_mesh.dirty.num_data),
                           np.asarray(res_one.dirty.num_data),
                           rtol=2e-3, atol=2e-3)
np.testing.assert_array_equal(np.asarray(res_mesh.dirty.cat_codes),
                              np.asarray(res_one.dirty.cat_codes))

print(f"MULTIHOST_OK {proc_id}", flush=True)
