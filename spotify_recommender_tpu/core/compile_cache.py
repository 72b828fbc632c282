"""Where JAX keeps its persistent compilation cache.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when it is set, nothing here
overrides it.  Otherwise the cache lives at a fixed `<repo>/.jax_cache`
(listed in .gitignore): the path is part of the cache key, so a directory
that moved between runs would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; return that path."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
