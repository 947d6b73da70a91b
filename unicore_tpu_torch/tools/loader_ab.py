"""A/B of the optimizer and loader plane on one card: the train CLI on a
full-width BERT-base in bf16 with SR (the configuration of ``chip_smoke.py``
phase 10a: batch 8 x ``--update-freq 2``, documents of 380-510 words from a
~30k-word dictionary, ``--seq-pad-multiple 128``) under each of

* ``sync``: ``--num-workers 0 --data-buffer-size 0`` (batches load on the
  training thread, between updates);
* ``default``: the defaults (1 loader thread behind a 10-batch buffer);
* ``workers2_prefetch``: ``--num-workers 2 --prefetch-to-device``;
* ``fused_sync`` and ``fused_workers2_prefetch``: the same two with
  ``--fused-adam``,

run in turns (each configuration, then the same in reverse order), each
for ``--updates`` updates without validation or checkpoints.  With
``--parent DIR`` (an unpacked checkout of another commit) its train CLI runs
``--num-workers 0`` first and last (``parent_sync``), as like-for-like for
``sync`` (a tree without ``--data-buffer-size`` loads on the training
thread).  Prints one
``loader_ab`` JSON line a run: the median step ms (inside ``train_step``),
the median wall ms from one update's end to the next's (loading
included), the K-a / K-b launches, the card and its power limit.  Run
from the root of a checkout on a machine with one NVIDIA card::

    python -m unicore_tpu_torch.tools.loader_ab [--updates 12]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

CONFIGS = {
    "sync": ["--num-workers", "0", "--data-buffer-size", "0"],
    "default": [],
    "workers2_prefetch": ["--num-workers", "2", "--prefetch-to-device"],
    "fused_sync": ["--fused-adam", "--num-workers", "0", "--data-buffer-size", "0"],
    "fused_workers2_prefetch": ["--fused-adam", "--num-workers", "2", "--prefetch-to-device"],
}


def write_corpus(data: Path, docs: int, seed: int = 0, symbols: int = 30000):
    """dict.txt and a train split of ``docs`` documents of 380-510 words
    with Zipf-like word frequencies (``chip_smoke.py``'s corpus)."""
    from unicore_tpu_torch.data import make_builder

    data.mkdir(parents=True, exist_ok=True)
    words = [f"w{i}" for i in range(symbols)]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (data / "dict.txt").write_text("\n".join(vocab) + "\n")
    rng = np.random.default_rng(seed)
    freq = 1.0 / np.arange(10, symbols + 10)
    builder = make_builder(str(data / "train"))
    for _ in range(docs):
        picks = rng.choice(symbols, size=int(rng.integers(380, 511)), p=freq / freq.sum())
        builder.add_item(" ".join(words[i] for i in picks))
    builder.finalize()


def run(data: Path, save: Path, updates: int, flags, tree: Path):
    argv = [
        sys.executable, "-m", "unicore_tpu_torch.cli.train", str(data), "--task", "bert",
        "--loss", "masked_lm", "--arch", "bert_base", "--optimizer", "adam",
        "--adam-betas", "(0.9, 0.98)", "--adam-eps", "1e-6", "--weight-decay", "1e-4",
        "--clip-norm", "1.0", "--lr-scheduler", "polynomial_decay", "--lr", "1e-4",
        "--warmup-updates", "5", "--total-num-update", str(updates),
        "--max-update", str(updates), "--batch-size", "8", "--update-freq", "2",
        "--seq-pad-multiple", "128", "--bf16", "--bf16-sr", "--disable-validation",
        "--no-save", "--log-interval", "100", "--save-dir", str(save), "--seed", "1", *flags,
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tree) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(argv, capture_output=True, text=True, env=env, timeout=900,
                          cwd=str(tree))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TRAIN stats ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"train CLI exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("TRAIN stats "):])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--updates", type=int, default=12)
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of another commit, run as parent_sync")
    opts = parser.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30).stdout.strip()
    Path("build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=Path("build")) as tmp:
        tmp = Path(tmp)
        write_corpus(tmp / "data", docs=16 * (opts.updates + 2))
        configs = dict(CONFIGS)
        order = list(CONFIGS) + list(reversed(CONFIGS))
        if opts.parent is not None:
            configs["parent_sync"] = ["--num-workers", "0"]
            order = ["parent_sync"] + order + ["parent_sync"]
        for i, name in enumerate(order):
            tree = opts.parent.resolve() if name == "parent_sync" else Path.cwd()
            stats = run(tmp.resolve() / "data", tmp.resolve() / f"save{i}", opts.updates,
                        configs[name], tree)
            launches = stats["kernel_launches"]
            print("loader_ab " + json.dumps({
                "config": name, "flags": configs[name], "turn": i,
                "median_step_ms": stats["median_step_ms"],
                "median_update_wall_ms": stats.get("median_update_wall_ms"),
                "step_ms": stats["step_ms"], "update_wall_ms": stats.get("update_wall_ms"),
                "peak_memory_bytes": stats["peak_memory_bytes"],
                "multi_tensor_l2norm": launches.get("multi_tensor_l2norm"),
                "fused_adam": launches.get("fused_adam"), "card": stats["device"],
                "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
