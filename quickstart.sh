#!/usr/bin/env bash
# Guided build + smoke test (the operator entry point; equivalent role to
# the reference's quickstart.sh:20-100 dependency-probe/build/demo flow).
set -euo pipefail

echo "=== spotify_recommender_tpu quickstart ==="

# 1. dependency probe
echo "--- checking dependencies"
python - <<'EOF'
import importlib, sys
missing = [m for m in ("jax", "optax", "numpy", "scipy") if importlib.util.find_spec(m) is None]
if missing:
    sys.exit(f"missing python deps: {missing}")
import jax
print(f"jax {jax.__version__}, default backend: {jax.default_backend()}, "
      f"devices: {[d.device_kind for d in jax.devices()]}")
EOF

# 2. install the package + native ingest library
echo "--- installing package (editable)"
pip install -e . --no-deps --no-build-isolation -q
if command -v g++ >/dev/null 2>&1; then
    echo "--- building native CSV parser"
    make -C native -s
else
    echo "--- g++ not found; using pure-Python CSV parser"
fi

# 3. run the test suite (virtual 8-device CPU mesh)
echo "--- running tests"
python -m pytest tests/ -q -x

# 4. demo on a synthetic catalog
echo "--- demo: preprocess + recommend"
DEMO_DIR=$(mktemp -d)
trap 'rm -rf "$DEMO_DIR"' EXIT
python - "$DEMO_DIR" <<'EOF'
import sys, pathlib
sys.path.insert(0, "tests")
from conftest import make_songs_csv
make_songs_csv(pathlib.Path(sys.argv[1]) / "songs.csv", n_rows=2000, n_genres=8)
EOF
cd "$DEMO_DIR"
python -m spotify_recommender_tpu --preprocess songs.csv | tail -4
python -m spotify_recommender_tpu --song "Song 42" -n 5

echo
echo "=== quickstart complete ==="
echo "Try: python -m spotify_recommender_tpu benchmark --items 100000"
