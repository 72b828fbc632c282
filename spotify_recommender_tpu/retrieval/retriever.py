"""Retriever: the public retrieval API.

Equivalent of the reference's `Recommender` class
(reference Recommender.h:28-130), rebuilt around device-resident state:

- `initialize(songs)` → constructing a Retriever from a Catalog: features
  and norms are pushed to device **once** (the reference's one-time H2D
  copy, Recommender.cu:162-170) and reused by every query;
- `recommend / recommendByName / recommendByIndex`
  (reference Recommender.cu:356-372, :275-318) → `recommend_by_id /
  recommend_by_name / recommend_by_index`, each returning ranked
  `Recommendation` records;
- plus what the reference lacks: `retrieve()` — batched many-query
  retrieval with the top-k selected on device (the path is chosen per call
  by retrieval/path.py), and optional mesh sharding of the catalog
  (parallel/sharding.py).

Only k (index, score) pairs ever leave the device — the reference pulled
the full N-float score vector to host per query (Recommender.cu:248-249).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spotify_recommender_tpu.core.config import RetrievalConfig
from spotify_recommender_tpu.core.logging import get_logger
from spotify_recommender_tpu.data.catalog import Catalog
from spotify_recommender_tpu.retrieval.index import CatalogIndex
from spotify_recommender_tpu.retrieval.path import choose_path, score_topk

log = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class Recommendation:
    """One ranked result (reference Recommender.h:12-22 + display fields
    main.cpp:117-122)."""

    row: int
    score: float
    track_id: str
    track_name: str
    artists: str
    genre: str


class Retriever:
    def __init__(
        self,
        catalog: Catalog,
        config: Optional[RetrievalConfig] = None,
        mesh: Optional[jax.sharding.Mesh] = None,
    ) -> None:
        if len(catalog) == 0:
            raise ValueError("Empty song database")
        self.catalog = catalog
        self.config = config or RetrievalConfig()
        self.mesh = mesh
        self.index = CatalogIndex(catalog.track_ids, catalog.track_names)

        if mesh is not None and mesh.shape.get("catalog", 1) > 1:
            from spotify_recommender_tpu.parallel.sharding import ShardedCatalog

            self._sharded = ShardedCatalog(
                catalog.features,
                catalog.norms,
                mesh,
                eps=self.config.eps,
                use_kernel=self.config.use_pallas,
            )
        else:
            self._sharded = None
            self._features = jax.device_put(
                np.asarray(catalog.features, np.float32)
            )
            self._norms = jax.device_put(np.asarray(catalog.norms, np.float32))
            self._valid = jnp.int32(len(catalog))
        self._platform = jax.default_backend()
        log.info(
            "retriever ready: %d items, path=%s, mesh=%s",
            len(catalog),
            self.backend,
            dict(mesh.shape) if mesh else None,
        )

    # ------------------------------------------------------------ paths

    def path_for(self, b: int, k: int) -> str:
        """The path a (b, k) call takes (retrieval/path.choose_path)."""
        if self._sharded is not None:
            return "sharded:" + self._sharded.path_for(b, k)
        return choose_path(
            self._platform, len(self.catalog), self.catalog.features.shape[1],
            b, k, use_kernel=self.config.use_pallas,
        )

    @property
    def backend(self) -> str:
        """Path of a single-query call at the configured k."""
        return self.path_for(1, self.config.top_k)

    def retrieve(
        self,
        queries: jnp.ndarray,
        k: Optional[int] = None,
        exclude_rows: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Batched exact top-k: queries (B, F) → (scores (B, k), rows (B, k)).

        `exclude_rows` masks one catalog row per query (self-exclusion);
        -1 disables masking for that query.  Slots no row can fill score
        -inf with row -1.
        """
        k = self.config.top_k if k is None else k
        queries = jnp.atleast_2d(jnp.asarray(queries, jnp.float32))
        b = queries.shape[0]
        exclude_rows = (
            jnp.full((b,), -1, jnp.int32)
            if exclude_rows is None
            else jnp.asarray(exclude_rows, jnp.int32)
        )
        if self._sharded is not None:
            return self._sharded.retrieve(queries, k, exclude_rows)
        return score_topk(
            queries, self._features, self._norms, exclude_rows, self._valid,
            k=k, eps=self.config.eps, path=self.path_for(b, k),
        )

    def retrieve_host(
        self,
        queries,
        k: Optional[int] = None,
        exclude_rows=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """`retrieve` with both results read back to host in one transfer."""
        s, i = jax.device_get(
            self.retrieve(queries, k=k, exclude_rows=exclude_rows)
        )
        return np.asarray(s), np.asarray(i)

    # ----------------------------------------------------- reference API

    def recommend_by_index(
        self, row: int, k: Optional[int] = None
    ) -> List[Recommendation]:
        """Top-k similar items to catalog row `row`, excluding itself
        (reference Recommender.cu:275-318)."""
        k = self.config.top_k if k is None else k
        if row < 0 or row >= len(self.catalog):
            raise IndexError(f"Invalid song index: {row}")
        k = min(k, len(self.catalog) - 1)
        query = self._query_vector(row)
        scores, rows = self.retrieve(
            query[None, :], k=k, exclude_rows=jnp.asarray([row], jnp.int32)
        )
        return self._materialize(np.asarray(rows)[0], np.asarray(scores)[0])

    def recommend_by_id(
        self, track_id: str, k: Optional[int] = None
    ) -> List[Recommendation]:
        row = self.index.find_by_track_id(track_id)
        if row is None:
            raise KeyError(f"Song with track_id '{track_id}' not found")
        return self.recommend_by_index(row, k)

    def recommend_by_name(
        self, name: str, k: Optional[int] = None
    ) -> List[Recommendation]:
        row = self.index.find_by_name(name)
        if row is None:
            raise KeyError(f"Song with name '{name}' not found")
        return self.recommend_by_index(row, k)

    def lookup(self, row: int) -> Recommendation:
        """Describe one catalog row (the reference's query-song display,
        main.cpp:104-112)."""
        return self._materialize([row], [1.0])[0]

    # ------------------------------------------------------------- helpers

    def _query_vector(self, row: int) -> jnp.ndarray:
        return jnp.asarray(self.catalog.features[row], jnp.float32)

    def _materialize(
        self, rows: Sequence[int], scores: Sequence[float]
    ) -> List[Recommendation]:
        cat = self.catalog
        out = []
        for r, s in zip(rows, scores):
            r = int(r)
            out.append(
                Recommendation(
                    row=r,
                    score=float(s),
                    track_id=str(cat.track_ids[r]),
                    track_name=str(cat.track_names[r]),
                    artists=str(cat.artists[r]),
                    genre=cat.genre_of(r),
                )
            )
        return out
