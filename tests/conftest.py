"""Test config: force an 8-device virtual CPU mesh (the standard JAX
substitute for multi-device hardware — SURVEY.md §4) before first device
use.

Tests marked ``gpu`` need the card (the compiled Triton kernel has no CPU
backend); they skip on the CPU.  Run them on a GPU machine with
``SRT_GPU_TESTS=1 python -m pytest -m gpu tests/``, which leaves the
platform to JAX instead of forcing the CPU."""

import os

_ON_GPU = os.environ.get("SRT_GPU_TESTS") == "1"
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from spotify_recommender_tpu.core.compile_cache import configure_compile_cache

configure_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's backend is a GPU (decided
    per test, never at import, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_songs_csv(
    path,
    n_rows: int = 200,
    n_genres: int = 5,
    seed: int = 0,
    extra_lines=(),
):
    """Write a synthetic Spotify-schema CSV with the reference's required
    columns (reference DataManager.cpp:121-125)."""
    rng = np.random.default_rng(seed)
    header = (
        "track_id,track_name,artists,album_name,danceability,energy,key,"
        "loudness,mode,speechiness,acousticness,instrumentalness,liveness,"
        "valence,tempo,track_genre"
    )
    keys = ["C", "C#", "D", "Eb", "E", "F", "F#", "G", "Ab", "A", "Bb", "B"]
    lines = [header]
    for i in range(n_rows):
        vals = rng.random(8)
        loud = -60 + 60 * rng.random()
        tempo = 40 + 180 * rng.random()
        key = keys[rng.integers(0, 12)] if i % 3 == 0 else str(rng.integers(0, 12))
        mode = ["Major", "Minor", "1", "0"][rng.integers(0, 4)]
        genre = f"genre-{rng.integers(0, n_genres)}"
        lines.append(
            f"id{i:05d},Song {i},Artist {i % 37},Album {i % 11},"
            f"{vals[0]:.4f},{vals[1]:.4f},{key},{loud:.3f},{mode},"
            f"{vals[2]:.4f},{vals[3]:.4f},{vals[4]:.4f},{vals[5]:.4f},"
            f"{vals[6]:.4f},{tempo:.3f},{genre}"
        )
    lines.extend(extra_lines)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path


@pytest.fixture
def songs_csv(tmp_path):
    return make_songs_csv(tmp_path / "songs.csv")


def reference_cpu_similarities(query: np.ndarray, features: np.ndarray) -> np.ndarray:
    """Direct transcription of the reference's CPU scorer semantics
    (reference Recommender.cu:256-273) in numpy fp32 — the parity oracle."""
    query = query.astype(np.float32)
    features = features.astype(np.float32)
    qnorm = np.sqrt(np.sum(query * query, dtype=np.float32))
    dots = features @ query
    norms = np.sqrt(np.sum(features * features, axis=1, dtype=np.float32))
    denom = norms * qnorm
    with np.errstate(divide="ignore", invalid="ignore"):
        sims = np.clip(dots / denom, -1.0, 1.0)
    return np.where(denom > 1e-8, sims, 0.0).astype(np.float32)


def reference_topk(sims: np.ndarray, query_index: int, k: int) -> list:
    """The reference's heap selection semantics (Recommender.cu:293-315):
    strict-greater replacement = lowest index wins on boundary ties;
    final order: descending score, ties by ascending index."""
    order = np.lexsort((np.arange(len(sims)), -sims))
    order = order[order != query_index]
    return list(order[:k])


def make_messy_songs_csv(path, n_clean: int = 2000, seed: int = 0):
    """A realistically-messy Spotify CSV (reference DATASET_INFO.md:53-58,
    DataManager.cpp:72-92 semantics): quoted commas, embedded doubled
    quotes, unicode names, CRLF + mixed line endings, control characters
    inside fields, bad numerics, blank genres, short rows, extra columns.
    Written as BYTES so line endings are exactly as authored.

    Returns (path, n_expected_invalid_crafted) — crafted rows marked bad
    below must be dropped by BOTH engines."""
    rng = np.random.default_rng(seed)
    header = (
        "track_id,track_name,artists,album_name,danceability,energy,key,"
        "loudness,mode,speechiness,acousticness,instrumentalness,liveness,"
        "valence,tempo,track_genre"
    )
    nums = "0.5,0.6,F#,-5.2,Major,0.1,0.2,0.3,0.4,0.5,120.0"
    crafted = [
        # (line, ends_with, valid?)
        ('"m001","Song, with comma","Björk; 坂本龍一",Alb,' + nums
         + ',"indie, pop"', "\n", True),
        ('m002,"She said ""hi""",Artémis,Alb,' + nums + ",jazz", "\r\n",
         True),
        # stray quote swallows a comma -> 15 fields -> dropped (short row)
        ('m003,ab"cd,ef"gh,Alb,' + nums + ",rock", "\n", False),
        # bad numeric -> dropped
        ("m004,Name Four,Art,Alb,0.x5,0.6,F#,-5.2,Major,0.1,0.2,0.3,0.4,"
         "0.5,120.0,rock", "\n", False),
        # blank genre -> dropped
        ("m005,Name Five,Art,Alb," + nums + ",", "\r\n", False),
        # empty track_name -> dropped
        ("m006,,Art,Alb," + nums + ",pop", "\n", False),
        # whitespace-padded numerics + tabs around strings -> valid
        ("\tm007\t,  Name Seven  ,Art,Alb, 0.5 ,\t0.6\t,F#, -5.2 ,Major,"
         "0.1,0.2,0.3,0.4,0.5, 120.0 ,  lo-fi  ", "\r\n", True),
        # scientific notation + numeric key/mode -> valid
        ("m008,Name Eight,Art,Alb,5e-1,6.0E-1,11,-5.2e0,1,0.1,0.2,0.3,"
         "0.4,0.5,1.2e2,electro", "\n", True),
        # control chars INSIDE a quoted field (\f, \v,  ): one row in
        # getline semantics — must NOT be split into fragments
        ('m009,"Name\fNine\v L ine",Art,Alb,' + nums + ",ambient",
         "\n", True),
        # quoted empty track_id -> dropped
        ('"",Name Ten,Art,Alb,' + nums + ",pop", "\n", False),
        # all-empty short row -> dropped
        (",,,,,,,,,,,,,,", "\r\n", False),
        # extra trailing columns -> valid (>= header width is fine)
        ("m012,Name Twelve,Art,Alb," + nums + ",synth,EXTRA1,EXTRA2",
         "\n", True),
        # lowercase symbolic key: keyToNumber uppercases first
        # (DataManager.cpp:26-27) -> VALID in both engines
        ("m013,Name Thirteen,Art,Alb,0.5,0.6,f#,-5.2,Major,0.1,0.2,0.3,"
         "0.4,0.5,120.0,rock", "\n", True),
        # key not in the table and not numeric -> dropped
        ("m013b,Name 13b,Art,Alb,0.5,0.6,H,-5.2,Major,0.1,0.2,0.3,"
         "0.4,0.5,120.0,rock", "\n", False),
        # mode word variant invalid -> dropped
        ("m014,Name Fourteen,Art,Alb,0.5,0.6,F#,-5.2,major?,0.1,0.2,0.3,"
         "0.4,0.5,120.0,rock", "\n", False),
        # unterminated quote: swallows the rest of the line's commas ->
        # short row -> dropped
        ('m015,"Unterminated,Art,Alb,' + nums + ",rock", "\n", False),
        # genre that is pure whitespace -> trimmed empty -> dropped
        ("m016,Name Sixteen,Art,Alb," + nums + ",   ", "\n", False),
    ]
    keys = ["C", "C#", "D", "Eb", "E", "F", "F#", "G", "Ab", "A", "Bb", "B"]
    out = [header + "\r\n"]
    for line, end, _ in crafted:
        out.append(line + end)
    for i in range(n_clean):
        vals = rng.random(8)
        loud = -60 + 60 * rng.random()
        tempo = 40 + 180 * rng.random()
        key = keys[rng.integers(0, 12)] if i % 3 == 0 else str(
            rng.integers(0, 12))
        mode = ["Major", "Minor", "1", "0"][rng.integers(0, 4)]
        genre = f"genre-{rng.integers(0, 40)}"
        name = f"Clean Song {i}" if i % 5 else f'"Clean, Song {i}"'
        artist = ["Zoë", "René", "千葉", "A$AP", f"Artist {i % 37}"][i % 5]
        end = "\r\n" if i % 7 == 0 else "\n"
        out.append(
            f"c{i:05d},{name},{artist},Album {i % 11},"
            f"{vals[0]:.4f},{vals[1]:.4f},{key},{loud:.3f},{mode},"
            f"{vals[2]:.4f},{vals[3]:.4f},{vals[4]:.4f},{vals[5]:.4f},"
            f"{vals[6]:.4f},{tempo:.3f},{genre}{end}"
        )
    path.write_bytes("".join(out).encode("utf-8"))
    n_valid_crafted = sum(1 for _, _, ok in crafted if ok)
    return path, n_valid_crafted + n_clean
