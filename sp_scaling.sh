#!/bin/bash
# LM CLI (cli/lm.py) on 4 ranks on NCCL, one GPU a rank, at GPT-2-small
# width (vocab 50257, dim 768, 12 layers, 12 heads, T 1024, global batch
# 8, SGD): data parallelism at --seq-shards 1 against the rings and
# Ulysses at --seq-shards 2 and 4. 2 epochs of 6 steps; each run's rank-0
# log goes to OUT_DIR/sp4_*.txt (default ./log); epoch 1's
# time_per_batch is the steady-state wall time a step. With SP_PROFILE=1
# it runs instead S 1 and ring_flash at S 2 and 4 for 16 steps of a
# 32-batch corpus under --profile-dir (rank 0's trace of steps 11-13) and
# prints, per run, the trace's device busy share and its kernel ms by
# family (NCCL's include the time a kernel waits for its peer). SP_RUNS
# picks the runs ("S attention" pairs, comma-separated). The package is
# the one of the working directory, so another checkout's runs from
# there on the same card.
#
#   bash sp_scaling.sh [OUT_DIR]     # on a machine with four GPUs
#   SP_RUNS="4 ring_flash,2 ring_flash" bash sp_scaling.sh [OUT_DIR]
#   SP_BASE="--device cpu --dim 32 --layers 2 --heads 4 --seq-len 32 \
#     -b 8 --vocab-size 64 --corpus-tokens 4096" bash sp_scaling.sh x
#                                    # the same runs as gloo CPU ranks
out=${1:-log}
base=${SP_BASE:---vocab-size 50257 --dim 768 --layers 12 --heads 12 --ffn-dim 3072 --seq-len 1024 -b 8}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null
mkdir -p "$out"
run() {
  tag=$1; shift
  # shellcheck disable=SC2086
  torchrun --nproc-per-node 4 -m distributed_model_parallel_tpu_torch.cli.lm \
    $base --optimizer sgd --lr 0.05 --checkpoint-dir "$out/ck_$tag" "$@" \
    > "$out/sp4_$tag.txt" 2>&1
  echo "== $tag $* rc=$?"
  grep -E "^==>|^epoch" "$out/sp4_$tag.txt"
  rm -rf "$out/ck_$tag"
}
summary() {  # device busy share and kernel ms by family of a trace
  python3 - "$1" <<'PY'
import json, sys
ev = [e for e in json.load(open(sys.argv[1]))["traceEvents"]
      if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy")]
if not ev:  # a CPU rehearsal records no device activity
    sys.exit(print(json.dumps({"trace": sys.argv[1], "kernels": 0})))
start = min(e["ts"] for e in ev)
span = max(e["ts"] + e["dur"] for e in ev) - start
fam = {}
for e in ev:
    n = e["name"].lower()
    k = ("nccl" if "nccl" in n else "flash" if "flash_" in n
         else "memcpy" if e["cat"] == "gpu_memcpy" else "other")
    fam[k] = fam.get(k, 0.0) + e["dur"] / 1e3
print(json.dumps({"trace": sys.argv[1], "span_ms": span / 1e3,
                  "busy_share": sum(fam.values()) / (span / 1e3),
                  "kernels": len(ev), "ms_by_family": fam}))
PY
}
if [ "${SP_PROFILE:-0}" = 1 ]; then
  for s in "1 ulysses_flash" "2 ring_flash" "4 ring_flash"; do
    set -- $s
    # 32 batches of the corpus, so the trace starts at step 11, past
    # the kernels' build and NCCL's warmup
    run "prof_s$1_$2" --epochs 1 --steps-per-epoch 16 --seq-shards "$1" \
      --attention "$2" --profile-dir "$out/prof_s$1_$2" \
      --corpus-tokens 262144
    summary "$out/prof_s$1_$2/trace_epoch0.json"
    rm -rf "$out/prof_s$1_$2"
  done
  exit 0
fi
IFS=, read -ra runs <<< "${SP_RUNS:-1 ulysses_flash,2 ring_flash,4 ring_flash,4 ulysses_flash,4 ring}"
for s in "${runs[@]}"; do
  set -- $s
  run "s$1_$2" --epochs 2 --steps-per-epoch 6 --seq-shards "$1" \
    --attention "$2"
done
