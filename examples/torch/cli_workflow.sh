#!/usr/bin/env bash
# The reference's end-to-end folder workflow on synthetic data, through the
# PyTorch port's CLI: partitioned inputs -> GPLVM fit -> embeddings +
# checkpoint -> resume. The counterpart of examples/cli_workflow.sh.
#
#   examples/torch/cli_workflow.sh [--device cpu] [-T ITERATIONS]
set -euo pipefail
DEVICE=cuda
ITERS=50
while [ $# -gt 0 ]; do
    case "$1" in
        --device) DEVICE=$2; shift 2 ;;
        -T) ITERS=$2; shift 2 ;;
        *) echo "usage: $0 [--device cuda|cpu] [-T ITERATIONS]" >&2; exit 2 ;;
    esac
done
# on the CPU in float64, as the JAX package's demos run there
DTYPE=float32
[ "$DEVICE" = cpu ] && DTYPE=float64
cd "$(dirname "$0")/../.."
WORK=$(mktemp -d)
python - <<PY
from gparml_tpu_torch import data
y, _ = data.synthetic_gplvm(n=500, d=8, q_true=2, seed=0)
data.save_partitioned("$WORK/inputs", y, 4, prefix="Y")
print("wrote 4 partitions to $WORK/inputs")
PY
python -m gparml_tpu_torch.cli -i "$WORK/inputs" -e "$WORK/embeddings" -s "$WORK/stats" \
    -T "$ITERS" -q 3 -m 20 --device "$DEVICE" --dtype "$DTYPE"
echo "--- resuming ---"
python -m gparml_tpu_torch.cli -i "$WORK/inputs" -e "$WORK/embeddings" -s "$WORK/stats" \
    -T $(( (ITERS * 2 + 4) / 5 )) -q 3 -m 20 --device "$DEVICE" --dtype "$DTYPE" --load
echo "artifacts in $WORK"
