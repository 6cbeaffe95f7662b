#!/bin/bash
# Run all examples (GPU or CPU jax). Outputs land in ./data/.
set -e
cd "$(dirname "$0")"
# the package lives one level up
export PYTHONPATH="$(pwd)/..:${PYTHONPATH:-}"
python example1.py "$@"
python example2.py "$@"
python example3.py "$@"
python example4.py "$@"
python example5_sharded.py "$@"
