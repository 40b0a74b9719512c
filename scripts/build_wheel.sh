#!/usr/bin/env bash
set -euo pipefail

# Build a distributable wheel + sdist for the headless CLI (`lut-tpu`).
# The rebuild's analog of the reference's PyInstaller app bundling
# (reference: scripts/build_dir_app.sh, scripts/build_onefile_app.sh) —
# a GUI-less deployment ships as a wheel; the native C++ helpers
# (cube parse, Floyd-Steinberg dither) compile on first use via
# lut_renderer_tpu.native_ext, so no binary artifacts ride the wheel.
# Output: dist/lut_renderer_tpu-*.whl, dist/lut-renderer-tpu-*.tar.gz

ROOT_DIR="$(cd -- "$(dirname -- "${BASH_SOURCE[0]}")/.." && pwd)"
cd "$ROOT_DIR"

export PYTHONNOUSERSITE=1

python -m pip wheel --no-deps -w dist . 2>/dev/null \
  || python setup.py bdist_wheel 2>/dev/null \
  || python -m build --wheel --no-isolation

# App icon set (reference paints it in-memory via Qt, icon.py:16-29; the
# headless analog generates the same motif as PNGs for any shell/installer).
python -m lut_renderer_tpu.app.cli icon --out dist/icons >/dev/null \
  && echo "icons: dist/icons/" || echo "icon generation skipped"

echo "built:"
ls -l dist/ | tail -n +2
