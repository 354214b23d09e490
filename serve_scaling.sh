#!/bin/bash
# Serve CLI (cli/serve.py) on NCCL ranks, one GPU a rank, at GPT-2-small
# width with chip_smoke.py phase 4's flags (vocab 50257, dim 768, 12
# layers, 12 heads, ffn 3072; 8 slots, max len 1024, prefill 128, 16
# requests of 16-128 prompt tokens, 32 new tokens each, greedy): the
# replicated layout on one rank, --layout tp at --model-shards 2 and 4
# with and without --collective-matmul, f32 and int8, and --layout sp at
# --seq-shards 2 and 4. Each run's report (rank 0's JSON) goes to
# OUT_DIR/serve_<tag>.json (default ./log); the script prints its
# tokens/s and decode p50 / p99. SERVE_RUNS picks the runs ("layout
# shards dtype [cm]", comma-separated). The package is the one of the
# working directory.
#
#   bash serve_scaling.sh [OUT_DIR]      # on a machine with four GPUs
#   SERVE_RUNS="tp 2 int8 cm,sp 4 f32" bash serve_scaling.sh [OUT_DIR]
#   SERVE_BASE="--device cpu --vocab-size 97 --dim 32 --layers 2 \
#     --heads 4 --ffn-dim 64 --max-len 64 --prefill-len 16 \
#     --prompt-len-min 4 --prompt-len-max 16" bash serve_scaling.sh x
#                                        # the same runs as gloo CPU ranks
out=${1:-log}
base=${SERVE_BASE:---vocab-size 50257 --dim 768 --layers 12 --heads 12 --ffn-dim 3072 --max-len 1024 --prefill-len 128 --prompt-len-min 16 --prompt-len-max 128}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null
mkdir -p "$out"
IFS=, read -ra runs <<< "${SERVE_RUNS:-replicated 1 f32,replicated 1 int8,tp 2 f32,tp 2 f32 cm,tp 2 int8,tp 2 int8 cm,tp 4 f32,tp 4 f32 cm,tp 4 int8,tp 4 int8 cm,sp 2 f32,sp 4 f32}"
for spec in "${runs[@]}"; do
  set -- $spec
  layout=$1 shards=$2 dtype=$3 cm=$4
  flags="--layout $layout --compute-dtype $dtype"
  case $layout in
    tp) flags="$flags --model-shards $shards" ;;
    sp) flags="$flags --seq-shards $shards" ;;
  esac
  [ -n "$cm" ] && flags="$flags --collective-matmul"
  tag=${layout}${shards}_${dtype}${cm:+_cm}
  # shellcheck disable=SC2086
  torchrun --nproc-per-node "$shards" \
    -m distributed_model_parallel_tpu_torch.cli.serve $base \
    --num-slots 8 --num-requests 16 --max-new-tokens 32 --seed 0 $flags \
    > "$out/serve_$tag.json" 2> "$out/serve_$tag.err"
  echo "== $tag $flags rc=$?"
  python3 - "$out/serve_$tag.json" <<'PY'
import json, sys
text = open(sys.argv[1]).read()
start = text.find("{\n")
if start < 0:
    sys.exit(print("no report"))
rep = json.loads(text[start:])["serving"]
print(json.dumps({k: rep.get(k) for k in (
    "device", "layout", "shards", "collective_matmul", "compute_dtype",
    "tokens_per_s", "decode_p50_ms", "decode_p99_ms", "decode_steps",
    "generated_tokens")}))
PY
done
