"""``render_novel_view(None, data, cfg, static_mode="geo")`` over items of
the pure-geometry reader, held on the device, one view in flight, cycling
through them; every item the window rendered is checked.

Set-up writes the seeded scene in the NVIDIA layout
(``harness/disk_scene.py``, raw frames at ``raw_scale`` times the
evaluation size; ``fixed_geometry``: its cameras and the rectangle's path
at the middle of the generator's ranges, its textures from the seed, so
that every seed gives the same cloud and the same work), builds ``NvidiaPureGeoEvalDataset`` over it (the whole
video's static cloud aggregated on the host, uncapped, as the CLI runs it),
reads ``n_targets`` items drawn from the seed, moves them to the device
(``contract_to_device``) with their softsplat noise drawn from the seed,
and removes the scene. The faults are this loop's own: ``alter_answer``
offsets one view's static layer and composite by 0.05; ``half_sources``
drops every other point of one view's static cloud.
"""

from __future__ import annotations

import time

import torch

from perfbench.harness import check, geo_check
from perfbench.harness import scene as scene_gen
from perfbench.harness.scene import rng_for


def fixed_geometry(disk_scene):
    """Set the scene's camera arc and the rectangle's path to the middle of
    the ranges ``scene.SceneParams`` draws them from (its textures stay
    the seed's). The static cloud's size follows the geometry (the
    background each camera adds, the hole the rectangle sweeps): over seeds
    it spans 199-208k points, and the K-NN's time its square, ~9 %."""
    p = disk_scene.params
    room_x = scene_gen.HALF_X - p.dyn_size[0] / 2 - scene_gen.ARC_X
    hw = disk_scene.raw_hw
    room_y = scene_gen.HALF_X * min(hw) / max(hw) - p.dyn_size[1] / 2 - scene_gen.ARC_Y
    sx, sy = room_x / scene_gen.ROOM_X, room_y / scene_gen.ROOM_Y
    p.sq_x = (0.0, sx * 0.825)
    p.sq_y = (0.0, sy * 0.15, 0.0)
    p.arc = (0.15, 0.045, 0.0)
    disk_scene.cams = [p.camera_pose(c / len(disk_scene.cams))
                       for c in range(len(disk_scene.cams))]
    return disk_scene


class Driver:
    def __init__(self, ctx, fault=None):
        self.ctx, self.fault = ctx, fault

    def setup(self):
        import pathlib
        import shutil
        import tempfile

        from pgdvs_tpu_torch.data.loader import contract_to_device
        from pgdvs_tpu_torch.data.nvidia_pure_geo import NvidiaPureGeoEvalDataset
        from pgdvs_tpu_torch.renderers import compose

        from perfbench.harness.disk_scene import SCENE, DiskScene

        ctx, config, t = self.ctx, self.ctx.config, self.ctx.traffic
        self.compose = compose
        self.rcfg = geo_check.render_config(config)
        h, w = config["hw"]
        if t["raw_scale"] != 2:
            raise ValueError("the reference reads the frames at half their written size")
        root = pathlib.Path(tempfile.mkdtemp(prefix=f"perfbench_geo_scene_{ctx.seed}_"))
        try:
            self.scene = fixed_geometry(DiskScene(ctx.seed, t["n_frames"], (2 * h, 2 * w),
                                                  (h, w), t["dyn_size"]))
            self.sources = self.scene.write(root, t["jpeg_quality"],
                                            t["occluded_coord_diff_max"], ctx.seed)
            dataset = NvidiaPureGeoEvalDataset(root, scene_ids=[SCENE],
                                               n_src_views_spatial=config["n_spatial"],
                                               tgt_height=h, st_pcl_capacity=0)
            geo_check.capture_coverage(self, dataset)
            picks = rng_for(ctx.seed, 6).choice(len(dataset), t["n_targets"], replace=False)
            self.items = [contract_to_device(dataset[int(i)], ctx.device) for i in picks]
        finally:
            shutil.rmtree(root, ignore_errors=True)
        self.noise = []
        for k in range(len(self.items)):
            seed = int(rng_for(ctx.seed, 100 + k).integers(1 << 62))
            gen = torch.Generator(device=ctx.device).manual_seed(seed)
            self.noise.append(torch.randn((h, w, 3), generator=gen, device=ctx.device))
        gen = torch.Generator().manual_seed(int(rng_for(ctx.seed, 3).integers(1 << 62)))
        n_rays = min(t["rays_checked_per_view"], h * w)
        self.idx = [torch.randperm(h * w, generator=gen)[:n_rays].sort().values.to(ctx.device)
                    for _ in self.items]
        self.kept = {}
        self._restore = geo_check.capture_static_decisions(self)
        for i in range(t["warmup_views"]):
            self.view(i)
        ctx.sync()
        self.kept.clear()

    def _data(self, j):
        data = self.items[j]
        if self.fault != "half_sources" or j != 0:
            return data
        valid = data["st_pcl_valid"].clone()
        valid[1::2] = False
        return {**data, "st_pcl_valid": valid}

    def render(self, i):
        j = i % len(self.items)
        self.last_keep = self.last_means = self.geo_keep = self.geo_means = None
        out = self.compose.render_novel_view(None, self._data(j), self.rcfg, static_mode="geo",
                                             noise=self.noise[j])
        if self.fault == "alter_answer" and j == 0:
            out = {**out, "geo_static_rgb": out["geo_static_rgb"] + 0.05,
                   "combined_rgb": out["combined_rgb"] + 0.05}
        return j, out

    def n_distinct(self):
        return len(self.items)

    def view(self, i):
        j, out = self.render(i)
        self.kept[j] = geo_check.kept_outputs(out, self.idx[j], self)

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
        check.restore(self._restore)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=False):
        """{"views", "per_view", "worst"} of the program against the
        reference over every item the window rendered; with ``control``
        also "control": the worst numbers of the control put in its place."""
        from perfbench.reference import geo

        config = self.ctx.config
        frames = geo_check.reference_frames(self.scene, self.sources)
        held = self.items[0]
        valid = held["st_pcl_valid"].bool()
        pcl = held["st_pcl_rgb"]
        host = pcl[valid].cpu().numpy()
        cloud = geo_check.program_cloud(host[:, :3], host[:, 3:], self.coverage,
                                        self.scene.n_frames)
        cloud_nums = geo_check.cloud_numbers(frames, cloud)
        points, colors = pcl[:, :3], pcl[:, 3:6]
        knn, std = config["st_outlier_knn"], config["st_outlier_std"]
        rule = geo.static_outlier_rule(points, valid, knn, std)
        if control:
            ctl_cloud = geo.aggregate_static_cloud(frames, low=True)
            ctl_cloud_nums = geo_check.cloud_numbers(frames, ctl_cloud)
            ctl_rule = geo.static_outlier_rule(points, valid, knn, std, low=True)
        per_view, per_ctl = [], []
        for j in sorted(self.kept):
            data, noise, idx = self.items[j], self.noise[j], self.idx[j]
            ref = geo_check.reference_view(config, data, noise, points, colors, valid, rule)
            nums = geo_check.compare(config, data, self.kept[j], ref, idx)
            per_view.append({**cloud_nums, **nums})
            if control:
                ctl = geo_check.reference_view(config, data, noise, points, colors, valid,
                                               ctl_rule, low=True)
                ctl_nums = geo_check.compare(config, data, geo_check.at_pixels(ctl, idx), ref,
                                             idx)
                per_ctl.append({**ctl_cloud_nums, **ctl_nums})
        out = {"views": len(per_view), "per_view": per_view, "worst": check.worst(per_view)}
        if control:
            out["control"] = check.worst(per_ctl)
        return out
