"""Dense ring-aggregate ("cofactor triple") pytrees and the ring operations.

The reference stores the triple as nested LIST/STRUCT vectors with per-column
hash maps for the categorical sections (SQL STRUCT at
/root/reference/duckdb_extension/src/triple/sum/sum.cpp:26-52, state at
sum/sum_state.h:14-57). Here we densify against a per-table vocabulary
(see schema.FeatureSchema) so that

    Triple  ==  the blocks of the sigma matrix (ML/utils.cpp:176-310)

      n        : f32[]      row count (N; product count after join-multiply)
      lin      : f32[d]     sum x_i
      quad     : f32[d,d]   sum x_i x_j        (FULL symmetric; the packed upper
                            triangle of the reference, sum_no_lift.cpp:128-146,
                            exists only at the serialization boundary)
      lin_cat  : f32[V]     per category: count          (lin_cat maps)
      num_cat  : f32[d,V]   per (num col, category): sum x   (quad_num_cat maps)
      cat_cat  : f32[V,V]   per category pair: co-occurrence (quad_cat maps;
                            full symmetric, same-column off-diagonal is 0)

With this layout the ring sum/subtract (sum_state.cpp:10-114, imputation/triple/
sub.cpp) are elementwise pytree adds, and the join multiply (mul.cpp:19-611)
is pure outer-product block assembly — dense device math, no hash maps.

NB aggregates (the 4-field variant, sum/sum_to_nb_agg.cpp:18-35) keep only the
diagonal of quad and the lin_cat counts.

All ops are shape-polymorphic over a leading batch axis (grouped aggregates);
scalars broadcast accordingly.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..schema import FeatureSchema


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Triple:
    n: jax.Array        # f32[] (or [G] for grouped)
    lin: jax.Array      # f32[d]
    quad: jax.Array     # f32[d, d]
    lin_cat: jax.Array  # f32[V]
    num_cat: jax.Array  # f32[d, V]
    cat_cat: jax.Array  # f32[V, V]

    @property
    def d(self) -> int:
        return self.lin.shape[-1]

    @property
    def v(self) -> int:
        return self.lin_cat.shape[-1]

    @staticmethod
    def zeros(schema: FeatureSchema, batch: tuple[int, ...] = (), dtype=jnp.float32) -> "Triple":
        d, v = schema.num_cols, schema.vocab_size
        return Triple(
            n=jnp.zeros(batch, dtype),
            lin=jnp.zeros(batch + (d,), dtype),
            quad=jnp.zeros(batch + (d, d), dtype),
            lin_cat=jnp.zeros(batch + (v,), dtype),
            num_cat=jnp.zeros(batch + (d, v), dtype),
            cat_cat=jnp.zeros(batch + (v, v), dtype),
        )

    def __add__(self, other: "Triple") -> "Triple":
        return triple_add(self, other)

    def __sub__(self, other: "Triple") -> "Triple":
        return triple_sub(self, other)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NBAgg:
    """Naive-Bayes aggregate: diagonal-only quad, counts only for categoricals
    (lift_to_nb_agg.cpp:101-118, sum/sum_to_nb_agg.cpp:18-35)."""
    n: jax.Array         # f32[]
    lin: jax.Array       # f32[d]
    quad_diag: jax.Array # f32[d]  (sum x^2 per numeric column)
    lin_cat: jax.Array   # f32[V]

    @property
    def d(self) -> int:
        return self.lin.shape[-1]

    @staticmethod
    def zeros(schema: FeatureSchema, batch: tuple[int, ...] = (), dtype=jnp.float32) -> "NBAgg":
        d, v = schema.num_cols, schema.vocab_size
        return NBAgg(
            n=jnp.zeros(batch, dtype),
            lin=jnp.zeros(batch + (d,), dtype),
            quad_diag=jnp.zeros(batch + (d,), dtype),
            lin_cat=jnp.zeros(batch + (v,), dtype),
        )

    def __add__(self, other: "NBAgg") -> "NBAgg":
        return triple_add(self, other)

    def __sub__(self, other: "NBAgg") -> "NBAgg":
        return triple_sub(self, other)


def triple_add(a, b):
    """Ring sum — the combine step of the reference's parallel aggregation
    (SumStateCombine, sum_state.cpp:10-114) and the client-side
    Triple::sum_triple (imputation/triple/sum.cpp). Elementwise on dense."""
    return jax.tree.map(jnp.add, a, b)


def triple_sub(a, b):
    """Ring subtract — the MICE delta operator (imputation/triple/sub.cpp)."""
    return jax.tree.map(jnp.subtract, a, b)


def triple_scale(a, s):
    """Scale every section by a scalar (used by multiply)."""
    return jax.tree.map(lambda x: x * s, a)


def triple_multiply(a: Triple, b: Triple) -> Triple:
    """Ring product for factorized joins (Triple::MultiplyFunction,
    mul.cpp:19-611). Result columns are [num_a ‖ num_b], [cat_a ‖ cat_b]:

      N        = Na * Nb                                  (mul.cpp:46-49)
      lin      = [lin_a * Nb ‖ lin_b * Na]                (mul.cpp:97-107)
      quad     = [[quad_a*Nb, lin_a⊗lin_b],
                  [lin_b⊗lin_a, quad_b*Na]]               (mul.cpp:262-289)
      lin_cat  = [lin_cat_a*Nb ‖ lin_cat_b*Na]            (mul.cpp:185-217)
      num_cat  = [[num_cat_a*Nb, lin_a⊗lin_cat_b],
                  [lin_b⊗lin_cat_a, num_cat_b*Na]]        (mul.cpp:377-446)
      cat_cat  = [[cat_cat_a*Nb, lin_cat_a⊗lin_cat_b],
                  [(lin_cat_a⊗lin_cat_b)ᵀ, cat_cat_b*Na]] (mul.cpp:542-598)

    The schema of the result is schema_a.concat(schema_b)."""
    na, nb = a.n, b.n
    lin = jnp.concatenate([a.lin * nb, b.lin * na], axis=-1)
    quad = jnp.block([
        [a.quad * nb, jnp.outer(a.lin, b.lin)],
        [jnp.outer(b.lin, a.lin), b.quad * na],
    ])
    lin_cat = jnp.concatenate([a.lin_cat * nb, b.lin_cat * na], axis=-1)
    num_cat = jnp.block([
        [a.num_cat * nb, jnp.outer(a.lin, b.lin_cat)],
        [jnp.outer(b.lin, a.lin_cat), b.num_cat * na],
    ])
    cross = jnp.outer(a.lin_cat, b.lin_cat)
    cat_cat = jnp.block([
        [a.cat_cat * nb, cross],
        [cross.T, b.cat_cat * na],
    ])
    return Triple(n=na * nb, lin=lin, quad=quad, lin_cat=lin_cat,
                  num_cat=num_cat, cat_cat=cat_cat)


def factorized_join_sum(a: Triple, b: Triple) -> Triple:
    """Fused `sum_triple(multiply_triple(A, B))` over aligned per-key triples —
    the reference's factorized-join aggregation (README.md:163-174: grouped
    triples per side, ring product per join key, ring sum over keys; see also
    the dead driver headers imputation/include/factorized_imputation_*.h).

    `a` and `b` are batched triples indexed by the join key, g = 0..G-1
    (missing keys contribute N=0 and therefore vanish, since every block of
    the product is scaled by the other side's count). Instead of
    materializing G ring products ([G, d+d', d+d'] quad blocks) and summing,
    each block of the sum IS a contraction over the key axis:

      Sum_g outer(lin_a[g], lin_b[g])  =  lin_a^T @ lin_b     (one matmul)
      Sum_g quad_a[g] * nb[g]          =  einsum('gij,g->ij')

    so the whole join-aggregate compiles to a handful of matmuls — O(G * m^2)
    FLOPs and O(m^2) memory, never O(G * m^2) memory."""
    na, nb = a.n, b.n
    w = lambda x, s: jnp.einsum('g...,g->...', x, s)
    quad = jnp.block([
        [w(a.quad, nb), a.lin.T @ b.lin],
        [b.lin.T @ a.lin, w(b.quad, na)],
    ])
    num_cat = jnp.block([
        [w(a.num_cat, nb), a.lin.T @ b.lin_cat],
        [b.lin.T @ a.lin_cat, w(b.num_cat, na)],
    ])
    cross = a.lin_cat.T @ b.lin_cat
    cat_cat = jnp.block([
        [w(a.cat_cat, nb), cross],
        [cross.T, w(b.cat_cat, na)],
    ])
    return Triple(
        n=jnp.vdot(na, nb),
        lin=jnp.concatenate([w(a.lin, nb), w(b.lin, na)], axis=-1),
        quad=quad,
        lin_cat=jnp.concatenate([w(a.lin_cat, nb), w(b.lin_cat, na)], axis=-1),
        num_cat=num_cat,
        cat_cat=cat_cat,
    )


def factorized_join_sum_nb(a: NBAgg, b: NBAgg) -> NBAgg:
    """NB-aggregate version of factorized_join_sum
    (sum_nb_agg over multiply_nb_agg products, mul_nb.cpp:20-268)."""
    na, nb = a.n, b.n
    w = lambda x, s: jnp.einsum('g...,g->...', x, s)
    return NBAgg(
        n=jnp.vdot(na, nb),
        lin=jnp.concatenate([w(a.lin, nb), w(b.lin, na)], axis=-1),
        quad_diag=jnp.concatenate(
            [w(a.quad_diag, nb), w(b.quad_diag, na)], axis=-1),
        lin_cat=jnp.concatenate([w(a.lin_cat, nb), w(b.lin_cat, na)], axis=-1),
    )


def nb_multiply(a: NBAgg, b: NBAgg) -> NBAgg:
    """Ring product for NB aggregates (Triple::multiply_nb, mul_nb.cpp:20-268):
    diagonal-quad scaling only, no cross sections."""
    na, nb = a.n, b.n
    return NBAgg(
        n=na * nb,
        lin=jnp.concatenate([a.lin * nb, b.lin * na], axis=-1),
        quad_diag=jnp.concatenate([a.quad_diag * nb, b.quad_diag * na], axis=-1),
        lin_cat=jnp.concatenate([a.lin_cat * nb, b.lin_cat * na], axis=-1),
    )


def sigma_from_triple(t: Triple) -> jax.Array:
    """Assemble the dense sigma matrix [[N, lin, lin_cat], [.., quad, num_cat],
    [.., .., cat_cat]] — the reference's build_sigma_matrix
    (ML/utils.cpp:176-310) becomes a block concat of the dense triple."""
    top = jnp.concatenate(
        [t.n[..., None, None],
         t.lin[..., None, :],
         t.lin_cat[..., None, :]], axis=-1)
    mid = jnp.concatenate(
        [t.lin[..., :, None], t.quad, t.num_cat], axis=-1)
    # cat_cat diagonal blocks carry the per-category counts on the diagonal
    # (sigma one-hot diagonal, ML/utils.cpp:230); dense cat_cat already has them
    # because onehotᵀ·onehot of the same column is diagonal with counts.
    bot = jnp.concatenate(
        [t.lin_cat[..., :, None],
         jnp.swapaxes(t.num_cat, -1, -2),
         t.cat_cat], axis=-1)
    return jnp.concatenate([top, mid, bot], axis=-2)


def triple_from_sigma(sigma: jax.Array, d: int) -> Triple:
    """Inverse of sigma_from_triple: slice the blocks back out."""
    return Triple(
        n=sigma[..., 0, 0],
        lin=sigma[..., 0, 1:1 + d],
        quad=sigma[..., 1:1 + d, 1:1 + d],
        lin_cat=sigma[..., 0, 1 + d:],
        num_cat=sigma[..., 1:1 + d, 1 + d:],
        cat_cat=sigma[..., 1 + d:, 1 + d:],
    )
