#!/usr/bin/env python
"""Benchmark entry point.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "details": {...}}

Workload: exact top-10 cosine retrieval, batched queries, 1M-item catalog,
one device, with auxiliary rows (10M items, 64-dim learned embeddings,
quality, serving, host streaming) in the details.
"""

import sys


def main() -> int:
    from spotify_recommender_tpu import benchmark
    from spotify_recommender_tpu.core.compile_cache import (
        configure_compile_cache,
    )

    configure_compile_cache()
    result = benchmark.run_benchmark_suite()
    print(benchmark.to_json_line(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
