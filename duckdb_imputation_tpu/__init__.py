"""duckdb_imputation_tpu — factorized in-database-style ML & MICE imputation on accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
eddbase/duckdb-imputation (PACMMOD'24 "In-Database Data Imputation"):
ring cofactor aggregates ("triples"), models trained directly from the
aggregates (linear/stochastic regression, LDA, QDA, gaussian+categorical
naive Bayes), and MICE imputation drivers with delta-aggregate retraining —
re-architected around dense device linear algebra: dense vocab layout,
masked Gram-matrix aggregation (XLA, or a Pallas kernel on the GPU),
shard_map data parallelism over device meshes.
"""

from .schema import FeatureSchema
from .ring import (
    NBAgg,
    Triple,
    lift,
    nb_lift,
    nb_multiply,
    sigma_from_triple,
    sum_nb_aggs,
    sum_to_nb_agg,
    sum_to_nb_agg_grouped,
    sum_to_triple,
    sum_to_triple_grouped,
    sum_triples,
    triple_add,
    triple_multiply,
    triple_sub,
)

__version__ = "0.1.0"
