"""Featurize throughput of two checkouts of the repo on one card, in turns.

    python -m sparkdl_tpu_torch.experiments.partition_turns OTHER \
        [--frames LABEL ...] [--passes N] [--json PATH]

``OTHER`` is another checkout (for instance the parent commit, unpacked
with ``git archive``). Through :func:`same_card.in_turns` (the order
OTHER, this, this, OTHER, a child process per turn), each turn imports
that checkout's port and featurizes with
``DeepImageFeaturizer(modelName="Xception")`` under ``"force"`` in the
default bf16 precision at batch 16, seeded 299×299 images, in the frames
of :data:`FRAMES` (or those ``--frames`` names): one partition of 32, 16 partitions of 4 (smaller than
a batch: coalesced), 4 partitions of 32 and 8 partitions of 64 (each
larger than a batch: chunked on the partition threads). A checkout with
``EngineConfig.max_workers`` runs each frame on 8 partition threads and
again on 1 (frame label ``@1``); a checkout without the partition pool
runs the partitions one after another. Each frame: two warm-up passes,
then ``--passes`` (:data:`PASSES`) timed passes (host clock around
``transform(df).collect()`` ended by ``torch.cuda.synchronize()``).
Prints one JSON row per frame with each turn's median images/s, every
pass's, and the median pass's phase timers summed over threads
(``stage_batch``, ``host_wait``, ``device_apply``, ms); needs the card.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from sparkdl_tpu_torch.experiments import same_card

#: (label, images, partitions) of each frame
FRAMES = [("one_partition_32", 32, 1), ("16_partitions_64", 64, 16),
          ("4_partitions_128", 128, 4), ("8_partitions_512", 512, 8)]
PASSES = 11

#: run in the checkout's root, which comes first on sys.path
_CHILD = """
import json, time
import numpy as np
import torch
import sparkdl_tpu_torch as s
from sparkdl_tpu_torch.core import profiling
from sparkdl_tpu_torch.image import imageIO
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
s.EngineConfig.device = "cuda"
s.EngineConfig.pallas_kernels = "force"
pool = hasattr(s.EngineConfig, "max_workers")
rng = np.random.default_rng(0)
feat = s.DeepImageFeaturizer(inputCol="image", outputCol="f",
                             modelName="Xception", batchSize=16)
out = {}
for label, n, parts in %(frames)r:
    imgs = [rng.integers(0, 256, (299, 299, 3), dtype=np.uint8)
            for _ in range(n)]
    df = s.DataFrame.fromColumns(
        {"image": imageIO.imageArraysToStructColumn(imgs, ["x"] * n)},
        numPartitions=parts)
    for workers in ((8, 1) if pool and parts > 1 else (None,)):
        if workers is not None:
            s.EngineConfig.max_workers = workers
        for _ in range(2):
            feat.transform(df).collect()
        passes = []
        for _ in range(%(passes)d):
            torch.cuda.synchronize()
            profiling.reset_phase_stats()
            t0 = time.perf_counter()
            feat.transform(df).collect()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            stats = profiling.phase_stats()
            passes.append((n / seconds, {
                k.split(".")[-1]: 1e3 * v["total_s"]
                for k, v in stats.items()}))
        key = label if workers in (None, 8) else f"{label}@{workers}"
        out[key] = passes
print(json.dumps(out))
"""


def main(other: Path, frames: Optional[List[str]] = None,
         passes: int = PASSES) -> List[dict]:
    chosen = [f for f in FRAMES if frames is None or f[0] in frames]
    code = _CHILD % {"frames": chosen, "passes": passes}
    turns = [(name, json.loads(stdout.strip().splitlines()[-1]))
             for name, stdout in same_card.in_turns(other, code)]
    rows = []
    # frames of either checkout (a frame only one has is None in the
    # other's turns)
    for key in dict.fromkeys(k for _, result in turns for k in result):
        passes = [result.get(key) for _, result in turns]
        median = [None if p is None else
                  sorted(p, key=lambda r: r[0])[len(p) // 2] for p in passes]
        rows.append({
            "frame": key, "turns": [name for name, _ in turns],
            "median_images_per_s": [m and m[0] for m in median],
            "median_pass_phase_ms": [m and m[1] for m in median],
            "images_per_s": [p and [r[0] for r in p] for p in passes]})
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--frames", nargs="+", default=None,
                        choices=[label for label, _, _ in FRAMES])
    parser.add_argument("--passes", type=int, default=PASSES)
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    rows = main(args.other.resolve(), args.frames, args.passes)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.json is not None:
        args.json.write_text(json.dumps(rows, indent=1))
