"""Driver of tiled-evaluation traffic: ``evaluate_arrays`` of the port's
``cli/evaluate.py`` in a closed loop, one split after another.

A split is ``images_per_split`` synthetic DRIVE-geometry images; a pool of
``pool_splits`` distinct splits is made at set-up from the seed and cycled.
Each call gets the split as host arrays, as the CLI hands its loaded
split over, and returns the FOV-masked maps, per-image Dice and AUC on the
host.  A sample of ``check_splits`` calls of the window, drawn from the
seed (reservoir sampling), is held against the plain reference once the
window has closed: the maps against the reference's maps, the AUC against
the reference's AUC, and the Dice and AUC the call returned against those
the reference works out from the call's own maps (kernel 2's sums and the
histograms, exact but for round-off)."""

from __future__ import annotations

import math
import random
import time

import torch

from harness import faults
from harness.common import check, quantile, subseed
from harness.roofline import chunks
from harness.synth import synthetic_drive
from reference.protocol import (
    evaluate_split,
    grid_centers,
    hard_dice,
    histogram_auc,
    plain_precision,
)


class EvalSplits:
    def __init__(self, run):
        self.run = run
        self.tr = run.traffic
        self.host = {}  # no host-clock lists for the readers

    # ------------------------------------------------------------- set-up
    def setup(self):
        from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays

        run, tr = self.run, self.tr
        self.evaluate = evaluate_arrays
        self.model = run.program_model()
        g = torch.Generator(device=run.device).manual_seed(
            subseed(run.seed, "data"))
        n = tr["images_per_split"]
        images, masks, labels = synthetic_drive(
            tr["pool_splits"] * n, tr["height"], tr["width"], g, run.device)
        images, masks, labels = (t.cpu().numpy()
                                 for t in (images, masks, labels))
        self.pool = [(images[i * n:(i + 1) * n], masks[i * n:(i + 1) * n],
                      labels[i * n:(i + 1) * n])
                     for i in range(tr["pool_splits"])]
        self.kwargs = dict(patch_size=tr["patch"],
                           inference_batch_size=tr["inference_batch"],
                           compute_dtype=run.compute_dtype, compute_auc=True,
                           threshold=tr["threshold"], device=run.device)
        for k in range(tr["warmup_splits"]):
            self.call(k % len(self.pool))

    def call(self, k: int) -> dict:
        return self.evaluate(self.model, *self.pool[k], **self.kwargs)

    # ------------------------------------------------------------- window
    def window(self, seconds: float, tracer):
        tr = self.tr
        rng = random.Random(subseed(self.run.seed, "check sample"))
        keep = tr["check_splits"]
        sample, lat = [], []
        failed = 0
        k = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or tracer.pending():
            tracer.before(k)
            with torch.profiler.record_function("bench.split"):
                ts = time.perf_counter()
                res = self.call(k % len(self.pool))
                lat.append(time.perf_counter() - ts)
            tracer.after(k)
            values = list(res["dice"]) + list(res["auc"])
            failed += not all(math.isfinite(v) for v in values)
            item = (k % len(self.pool), res)
            if len(sample) < keep:
                sample.append(item)
            else:
                j = rng.randrange(k + 1)
                if j < keep:
                    sample[j] = item
            k += 1
        elapsed = time.perf_counter() - t0
        n = tr["images_per_split"]
        self.sample = sample
        self.e2e = {"eval_images_per_s": k * n / elapsed,
                    "eval_split_p90_ms": quantile(lat, 0.9) * 1e3}
        self.attempted, self.failed = k, failed
        grid = len(grid_centers(n, tr["height"], tr["width"],
                                tr["patch"] // 2))
        self.counts = {"splits": tracer.count, "images": tracer.count * n,
                       "patches": tracer.count * grid,
                       "chunks": chunks(grid, tr["inference_batch"])}

    # ------------------------------------------------------------- checks
    def release(self):
        del self.model

    def reference(self, ref_model) -> list:
        """(call's result, what the reference makes of it) for each sampled
        call: the reference's own split (maps, Dice, AUC) and the Dice and
        AUC of the call's own maps."""
        tr, dev = self.tr, self.run.device
        pairs = []
        for k, res in self.sample:
            images, masks, labels = (torch.as_tensor(a, device=dev)
                                     for a in self.pool[k])
            with plain_precision():
                want = evaluate_split(ref_model, images, masks, labels,
                                      tr["patch"], tr["threshold"])
            maps = torch.as_tensor(res["pred_maps"], device=dev)
            want["dice_of_maps"] = hard_dice(
                (maps > tr["threshold"]).float(), labels).tolist()
            want["auc_of_maps"] = [histogram_auc(maps[i], labels[i],
                                                 masks[i])
                                   for i in range(maps.shape[0])]
            pairs.append((res, want))
        return pairs

    def verify(self, ref_model, limits: dict) -> list:
        pairs = self.reference(ref_model)
        return [check(name, NUMBERS[name](pairs), limits[name])
                for name in limits]


def _widest(pairs, got_key, want_key):
    return max(abs(a - b) for res, want in pairs
               for a, b in zip(res[got_key], want[want_key]))


def _map_gaps(pairs):
    for res, want in pairs:
        maps = torch.as_tensor(res["pred_maps"], device=want["maps"].device)
        yield (maps - want["maps"]).abs()


# The numbers the check can compare, each over the sampled calls: the
# widest gap of a stitched probability and the mean gap over the maps'
# pixels against the reference's maps; the widest gap of a per-image AUC
# against the reference's; the widest gap of a returned Dice and AUC
# against the reference's Dice and AUC of the call's own maps.  The cell's
# limits name those compared.
NUMBERS = {
    "map_gap": lambda pairs: max(float(d.max()) for d in _map_gaps(pairs)),
    "map_mean_gap": lambda pairs: sum(
        float(d.double().mean()) for d in _map_gaps(pairs)) / len(pairs),
    "auc_gap": lambda pairs: _widest(pairs, "auc", "auc"),
    "dice_of_maps_gap": lambda pairs: _widest(pairs, "dice",
                                              "dice_of_maps"),
    "auc_of_maps_gap": lambda pairs: _widest(pairs, "auc", "auc_of_maps"),
}

FAULTS = faults.EVAL
Driver = EvalSplits
