"""The single retrieval-path choice, the config it honours, error
propagation, compile-cache placement, and chip_smoke's refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spotify_recommender_tpu.core import compile_cache
from spotify_recommender_tpu.core.config import RetrievalConfig
from spotify_recommender_tpu.retrieval import retriever as rmod
from spotify_recommender_tpu.retrieval.path import (
    KERNEL,
    XLA,
    XLA_CHUNKED,
    choose_path,
    score_topk,
)

from test_retriever_suite import make_catalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,n,f,b,k,use_kernel,want",
    [
        ("gpu", 10_000_000, 12, 1024, 10, True, KERNEL),
        ("gpu", 10_000_000, 12, 1, 10, True, KERNEL),
        ("gpu", 1_000_000, 64, 1024, 10, True, KERNEL),
        ("gpu", 1000, 12, 8, 64, True, KERNEL),
        ("gpu", 10_000_000, 12, 8, 65, True, XLA_CHUNKED),
        ("gpu", 1000, 256, 8, 10, True, XLA),
        ("gpu", 1_000_000, 12, 8, 10, False, XLA_CHUNKED),
        ("cpu", 1_000_000, 12, 8, 10, True, XLA_CHUNKED),
        ("cpu", 262_144, 12, 8, 10, True, XLA),
        ("cpu", 262_145, 12, 8, 10, True, XLA_CHUNKED),
        ("cpu", 5, 12, 1, 10, True, XLA_CHUNKED),
    ],
)
def test_choose_path(platform, n, f, b, k, use_kernel, want):
    assert choose_path(platform, n, f, b, k, use_kernel=use_kernel) == want


@pytest.mark.parametrize(
    "kwargs",
    [{"dtype": "bfloat16"}, {"dtype": "bfloat16x2"}, {"dtype": "float16"},
     {"exact_scores": False}],
)
def test_config_rejects_removed_tiers(kwargs):
    with pytest.raises(ValueError):
        RetrievalConfig(**kwargs)


def test_retriever_reports_its_path():
    feats = np.random.default_rng(0).random((300, 12), dtype=np.float32)
    r = rmod.Retriever(make_catalog(feats))
    assert r.path_for(8, 10) == XLA == r.backend
    assert r.path_for(8, 400) == XLA_CHUNKED      # k > N pads by chunking


def test_kernel_error_propagates(monkeypatch):
    """A failing kernel is an error, not a silent switch to XLA: force the
    kernel path on the CPU (where the compiled Triton kernel cannot run)."""
    feats = np.random.default_rng(1).random((300, 12), dtype=np.float32)
    r = rmod.Retriever(make_catalog(feats))
    monkeypatch.setattr(rmod, "choose_path", lambda *a, **kw: KERNEL)
    assert r.backend == KERNEL
    with pytest.raises(ValueError, match="interpret mode"):
        r.retrieve(feats[:2], k=5)


def test_unknown_path_is_an_error():
    x = jnp.ones((16, 12), jnp.float32)
    with pytest.raises(ValueError, match="unknown retrieval path"):
        score_topk(
            x[:1], x, jnp.ones(16), jnp.full((1,), -1, jnp.int32),
            jnp.int32(16), k=3, eps=1e-8, path="certified",
        )


def test_xla_paths_agree_with_kernel_interpret():
    rng = np.random.default_rng(2)
    feats = rng.random((700, 12), dtype=np.float32)
    feats[[10, 20]] = feats[5]
    norms = np.linalg.norm(feats, axis=1).astype(np.float32)
    q = jnp.asarray(feats[[5, 6, 7]])
    excl = jnp.asarray([5, -1, 7], jnp.int32)
    out = {
        p: score_topk(
            q, jnp.asarray(feats), jnp.asarray(norms), excl, jnp.int32(650),
            k=12, eps=1e-8, path=p, interpret=p == KERNEL,
        )
        for p in (KERNEL, XLA, XLA_CHUNKED)
    }
    for p in (XLA, XLA_CHUNKED):
        np.testing.assert_array_equal(
            np.asarray(out[p][1]), np.asarray(out[KERNEL][1])
        )
        np.testing.assert_allclose(
            np.asarray(out[p][0]), np.asarray(out[KERNEL][0]), atol=1e-6
        )
    assert int(np.asarray(out[XLA][1]).max()) < 650


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    got = compile_cache.configure_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # untouched


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

