"""``render_novel_view`` over the seeded scene's target views, held on the
device, one view in flight, cycling through the targets; every target the
window rendered is checked."""

from __future__ import annotations

import time

import torch

from perfbench.harness import check, faults
from perfbench.harness.scene import Scene, rng_for
from perfbench.reference import render


class Driver:
    def __init__(self, ctx, fault=None):
        self.ctx, self.fault = ctx, fault

    def setup(self):
        from pgdvs_tpu_torch.renderers import compose

        from perfbench.harness.weights import load_seeded

        ctx, config = self.ctx, self.ctx.config
        self.compose = compose
        self.rcfg = check.render_config(config)
        self.models = check.meta_models(config, ctx.device)
        self.states = load_seeded(self.models, ctx.seed, ctx.device)
        t = ctx.traffic
        self.scene = Scene(ctx.seed, tuple(config["hw"]), t["n_frames"], t["n_targets"],
                           config["n_spatial"], ctx.device, t["dyn_size"])
        h, w = config["hw"]
        gen = torch.Generator().manual_seed(int(rng_for(ctx.seed, 3).integers(1 << 62)))
        n_rays = min(t["rays_checked_per_view"], h * w)
        self.idx = [torch.randperm(h * w, generator=gen)[:n_rays].sort().values.to(ctx.device)
                    for _ in self.scene.targets]
        self.kept = {}
        self._restore_outliers = check.capture_outlier_decisions(self)
        for i in range(t["warmup_views"]):
            self.view(i)
        ctx.sync()
        self.kept.clear()

    def render(self, i):
        j = i % len(self.scene.targets)
        data = faults.on_data(self.fault, self.scene.targets[j])
        self.last_keep = self.last_means = None
        out = self.compose.render_novel_view(self.models, data, self.rcfg, noise=data["noise"])
        return j, faults.on_output(self.fault, out, j == 0)

    def n_distinct(self):
        return len(self.scene.targets)

    def view(self, i):
        j, out = self.render(i)
        self.kept[j] = check.kept_outputs(out, self.idx[j], self.last_keep, self.last_means)

    def window(self, seconds, on_start):
        self.ctx.sync()
        on_start()
        t0 = time.perf_counter()
        n = 0
        while True:
            self.view(n)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.ctx.sync()
        return n, time.perf_counter() - t0

    def profile(self, n, start, view):
        start()
        for i in range(n):
            with view():
                self.render(i)

    def release(self):
        check.restore(self._restore_outliers)
        del self.models
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=False):
        """{"views", "per_view", "worst"} of the program against the
        reference over every target the window rendered; with ``control``
        also "control": the worst numbers of the control put in its place."""
        config = self.ctx.config
        ref_models = check.reference_models(config, self.states, self.ctx.device)
        feats = {}
        per_view, per_ctl = [], []
        for j in sorted(self.kept):
            data = self.scene.targets[j]
            ids = self.scene.frame_ids[j]

            def feats_of(low):
                for k, f in enumerate(ids):
                    if (f, low) not in feats:
                        feats[f, low] = render.features(
                            ref_models[0], data["rgb_src_spatial"][k][None], low)[0]
                return torch.stack([feats[f, low] for f in ids])

            nums, ctl = check.hold(config, ref_models, feats_of, data,
                                   data["noise"], self.idx[j], self.kept[j], control)
            per_view.append(nums)
            if ctl is not None:
                per_ctl.append(ctl)
        out = {"views": len(per_view), "per_view": per_view, "worst": check.worst(per_view)}
        if control:
            out["control"] = check.worst(per_ctl)
        return out
