"""``Evaluator.run`` over an NVIDIA-layout scene written from the seed
(``harness/disk_scene.py``), items in the reader's order, repeated so that
the window never runs out.

The items checked are drawn from the seed before the window: one in each
block of ``check_every`` items from the window's first, ``items_checked``
blocks. Only those are kept (the render at the sampled pixels and the
dynamic layer on the device, the contract and the scored image on the
host), so what the window holds does not grow with the items it completes.
"""

from __future__ import annotations

import contextlib
import time

import torch

from perfbench.harness import check, faults
from perfbench.harness.scene import rng_for
from perfbench.reference import nets, render


class WindowClosed(Exception):
    """Raised after the item that crosses the window's end, to leave
    ``Evaluator.run``."""


class CycledItems:
    """The reader's items in its order, repeated; keeps the contract of each
    item in ``keep`` (host arrays) for the check."""

    KEEP = ("rgb_tgt", "rgb_src_spatial", "dyn_mask_src_spatial", "flat_cam_src_spatial",
            "flat_cam_tgt", "depth_range", "rgb_src_temporal", "dyn_mask_src_temporal",
            "depth_src_temporal", "flat_cam_src_temporal", "flow_fwd", "flow_fwd_occ_mask",
            "time_tgt", "time_src_temporal", "seq_ids", "misc")

    def __init__(self, dataset, repeats, keep):
        self.dataset, self.n, self.keep = dataset, len(dataset) * repeats, keep
        self.items = {}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.assemble(i)

    def assemble(self, i):
        item = self.dataset[i % len(self.dataset)]
        if i in self.keep:
            self.items[i] = {k: item[k] for k in self.KEEP}
        return item


class Driver:
    def __init__(self, ctx, fault=None):
        self.ctx, self.fault = ctx, fault
        self.root = None

    def setup(self):
        import pathlib
        import tempfile

        from pgdvs_tpu_torch.data.nvidia_eval import NvidiaEvalDataset
        from pgdvs_tpu_torch.engines import evaluator
        from pgdvs_tpu_torch.metrics.lpips import BUNDLED_HEADS, LPIPS

        from perfbench.harness.disk_scene import SCENE, DiskScene
        from perfbench.harness.weights import load_seeded

        ctx, config, t = self.ctx, self.ctx.config, self.ctx.traffic
        self.evaluator = evaluator
        self.rcfg = check.render_config(config)
        self.models = check.meta_models(config, ctx.device)
        self.states = load_seeded(self.models, ctx.seed, ctx.device)
        self.lpips_net = None
        if t["lpips"]:
            with torch.device("meta"):
                lp = LPIPS()
            lp = lp.to_empty(device=ctx.device).eval()
            heads = torch.load(BUNDLED_HEADS, map_location="cpu", weights_only=True)
            conv_state = load_seeded([lp.convs], ctx.seed + 1, ctx.device)[0]
            lins = {f"lins.{k}": heads[f"lin{k}.model.1.weight"].reshape(-1).to(ctx.device)
                    for k in range(5)}
            self.lpips_state = {**{f"convs.{k}": v for k, v in conv_state.items()}, **lins}
            lp.load_state_dict(self.lpips_state)
            lp.register_buffer("shift", torch.tensor((-0.030, -0.088, -0.188), device=ctx.device)
                               .view(1, 3, 1, 1), persistent=False)
            lp.register_buffer("scale", torch.tensor((0.458, 0.448, 0.450), device=ctx.device)
                               .view(1, 3, 1, 1), persistent=False)
            self.lpips_net = lp
        self.root = pathlib.Path(tempfile.mkdtemp(prefix=f"perfbench_scene_{ctx.seed}_"))
        self.scene = DiskScene(ctx.seed, t["n_frames"], t["raw_hw"], config["hw"],
                               t["dyn_size"])
        self.sources = self.scene.write(self.root, t["jpeg_quality"],
                                        t["occluded_coord_diff_max"], ctx.seed)
        dataset = NvidiaEvalDataset(self.root, scene_ids=[SCENE],
                                    n_src_views_spatial=config["n_spatial"],
                                    tgt_height=config["hw"][0])
        # item 0 fills the loader before the window; the window's items are 1, 2, ...
        every = t["check_every"]
        picks = rng_for(ctx.seed, 5).integers(0, every, t["items_checked"])
        self.checked = {1 + k * every + int(p) for k, p in enumerate(picks)}
        self.altered = min(self.checked)
        self.items = CycledItems(dataset, repeats=50, keep=self.checked)
        self.ev = evaluator.Evaluator(self.models, self.rcfg, out_dir=str(self.root / "out"),
                                      lpips_net=self.lpips_net, save_vis=t["save_vis"])
        self.kept, self.preds, self.current = {}, {}, None
        h, w = config["hw"]
        self.n_rays = min(t["rays_checked_per_view"], h * w)
        self._install_capture()
        for i in range(t["warmup_views"]):
            self.ev.eval_item(dataset[i % len(dataset)], item_id=f"warmup{i}", seed=i)
        ctx.sync()

    def idx(self, i):
        h, w = self.ctx.config["hw"]
        gen = torch.Generator().manual_seed(int(rng_for(self.ctx.seed, 1000 + i).integers(1 << 62)))
        return torch.randperm(h * w, generator=gen)[:self.n_rays].sort().values

    def _install_capture(self):
        """Keep, for a checked item ``self.current``, what the check compares:
        the render's outputs at the item's sampled pixels (on the device) and
        the scored image (host)."""
        ev, mod = self.ev, self.evaluator
        render_view = mod.render_novel_view
        score = ev._score
        eval_item = ev.eval_item

        def render_kept(*a, **kw):
            self.last_keep = self.last_means = None
            out = faults.on_output(self.fault, render_view(*a, **kw),
                                   self.current == self.altered)
            if self.current in self.checked:
                self.kept[self.current] = check.kept_outputs(
                    out, self.idx(self.current).to(self.ctx.device), self.last_keep,
                    self.last_means)
            return out

        def score_kept(pred, data, item_id, wall):
            if self.current in self.checked:
                self.preds[self.current] = pred
            return score(pred, data, item_id, wall)

        def eval_item_tracked(data, item_id="item", seed=0):
            self.current = seed if item_id.isdigit() else None
            return eval_item(faults.on_data(self.fault, data), item_id=item_id, seed=seed)

        mod.render_novel_view = render_kept
        ev._score = score_kept
        ev.eval_item = eval_item_tracked
        self._restore = [(mod, "render_novel_view", render_view)]
        self._restore += check.capture_outlier_decisions(self)

    def window(self, seconds, on_start):
        """``Evaluator.run`` over the items; the clock starts once its first
        item (the loader filling up) is done, and stops after the item that
        crosses ``seconds``."""
        ctx, ev = self.ctx, self.ev
        inner = ev.eval_item
        done = [0]
        t0 = [None]

        def counted(data, item_id="item", seed=0):
            rec = inner(data, item_id=item_id, seed=seed)
            if t0[0] is None:
                ctx.sync()
                on_start()
                t0[0] = time.perf_counter()
                return rec
            done[0] += 1
            if time.perf_counter() - t0[0] >= seconds:
                raise WindowClosed
            return rec

        ev.eval_item = counted
        try:
            ev.run(self.items)
            raise RuntimeError("the window ran out of items")
        except WindowClosed:
            ctx.sync()
            elapsed = time.perf_counter() - t0[0]
        ev.eval_item = inner
        return done[0], elapsed

    def n_distinct(self):
        return len(self.items.dataset)

    def view(self, i):
        """Item i + 1 outside the window (the readings), kept whether drawn
        or not."""
        self.checked.add(i + 1)
        self.ev.eval_item(self.items.assemble(i + 1), item_id=f"{i + 1:06d}", seed=i + 1)

    def profile(self, n, start, view):
        """n items through ``Evaluator.run`` after one that fills the
        loader, each inside ``view()``."""
        ev = self.ev
        inner = ev.eval_item
        done = [0]

        def profiled(data, item_id="item", seed=0):
            if done[0] == 1:
                start()
            with view() if done[0] >= 1 else contextlib.nullcontext():
                rec = inner(data, item_id="profile", seed=seed)
            done[0] += 1
            if done[0] > n:
                raise WindowClosed
            return rec

        ev.eval_item = profiled
        try:
            ev.run(self.items)
        except WindowClosed:
            pass
        ev.eval_item = inner

    def release(self):
        check.restore(self._restore)
        del self.models, self.ev
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=False):
        """The program against the reference on every checked item the window
        scored: the render (sampled pixels, the dynamic layer whole), the
        reader's contract, the written scores."""
        import pickle
        import shutil

        import numpy as np

        from perfbench.reference import reader as rr
        from perfbench.reference import scores

        ctx, config = self.ctx, self.ctx.config
        dev = ctx.device
        ref_models = check.reference_models(config, self.states, dev)
        ref_lpips = None
        if self.lpips_net is not None:
            with torch.device("meta"):
                ref_lpips = nets.AlexLPIPS()
            ref_lpips = ref_lpips.to_empty(device=dev).eval()
            ref_lpips.load_state_dict(self.lpips_state)
        feats = {}
        per_view, per_ctl = [], []
        n_frames = self.scene.n_frames
        for i in sorted(self.kept):
            item = self.items.items[i]
            data = {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                        if isinstance(v, np.ndarray) else v) for k, v in item.items()}
            f = int(item["seq_ids"][0])
            spatial = [int(s) for s in item["seq_ids"][1:1 + config["n_spatial"]]]
            temporal = [int(s) for s in item["seq_ids"][1 + config["n_spatial"]:]]
            noise = torch.randn(data["rgb_src_temporal"][0].shape,
                                generator=torch.Generator(device=dev).manual_seed(i),
                                dtype=data["rgb_src_temporal"].dtype, device=dev)
            with open(self.root / "out" / f"{i:06d}.pkl", "rb") as fh:
                written = pickle.load(fh)
            ref_rgb = np.concatenate([rr.half_rgb(self.sources[g]["rgb"])[None]
                                      for g in spatial + temporal + [f]])

            def feats_of(low):
                for k, g in enumerate(spatial):
                    if (g, low) not in feats:
                        feats[g, low] = render.features(ref_models[0],
                                                        data["rgb_src_spatial"][k][None], low)[0]
                return torch.stack([feats[g, low] for g in spatial])

            nums, ctl = check.hold(config, ref_models, feats_of, data, noise,
                                   self.idx(i).to(dev), self.kept[i], control)
            got = np.concatenate([item["rgb_src_spatial"], item["rgb_src_temporal"],
                                  item["rgb_tgt"][None]])
            sc = scores.nvidia_scores(self.preds[i], item["rgb_tgt"],
                                      item["misc"]["tgt_dyn_mask"], ref_lpips)
            nums.update(_pixel_gaps(got, ref_rgb))
            nums["reader_geom"] = self._reader_geom(item, f, spatial, temporal, n_frames, False)
            nums.update(_score_gaps(written, sc))
            per_view.append(nums)
            if control:
                # 4-bit pixels, bf16 geometry, float32 scores and bf16 LPIPS
                ctl.update(_pixel_gaps(np.round(ref_rgb * 15.0) / 15.0, ref_rgb))
                ctl["reader_geom"] = self._reader_geom(item, f, spatial, temporal, n_frames,
                                                       True)
                ctl.update(_score_gaps(scores.nvidia_scores(
                    self.preds[i], item["rgb_tgt"], item["misc"]["tgt_dyn_mask"], ref_lpips,
                    low=True), sc))
                per_ctl.append(ctl)
        shutil.rmtree(self.root, ignore_errors=True)
        out = {"views": len(per_view), "per_view": per_view, "worst": check.worst(per_view)}
        if control:
            out["control"] = check.worst(per_ctl)
        return out

    def _reader_geom(self, item, f, spatial, temporal, n, low):
        """The largest relative gap of the contract's geometry and times
        (cameras, depth range, depths, flow, the target's and the temporal
        sources' times: frame indices) from the reference's; 1.0 where a
        source or a mask pixel differs. ``low``: the reference's own values
        rounded to bf16 against it."""
        import numpy as np

        from perfbench.reference import reader as rr

        sc = self.scene
        eh, ew = sc.eval_hw

        def rel(a, b):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))

        def bf16(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()

        gaps = [0.0 if temporal == rr.temporal_ids(f, n) else 1.0]
        dists = [np.linalg.norm(sc.c2w(g)[:3, 3] - sc.c2w(f)[:3, 3]) for g in spatial]
        gaps.append(rel(np.sort(dists), rr.spatial_distances(f, n, sc.c2w, len(spatial))))
        raw = self.sources
        cams = [rr.flat_cam(sc.eval_hw, sc.raw_hw, sc.c2w(g)) for g in spatial]
        ref = {
            "flat_cam_tgt": rr.flat_cam(sc.eval_hw, sc.raw_hw, sc.c2w(f)),
            "flat_cam_src_spatial": np.stack(cams),
            "flat_cam_src_temporal": np.stack([rr.flat_cam(sc.eval_hw, sc.raw_hw, sc.c2w(g))
                                               for g in temporal]),
            "depth_src_temporal": np.stack([rr.half_depth(raw[g]["depth"])[..., None]
                                            for g in temporal]),
            "depth_range": rr.depth_range([rr.half_depth(raw[g]["depth"])
                                           for g in spatial], cams, sc.c2w(f)),
            "time_tgt": np.array([f], np.float64),
            "time_src_temporal": np.array(temporal, np.float64),
        }
        if temporal[0] != temporal[1]:
            from perfbench.harness.scene import flow_between

            a = sc.frame(temporal[0], sc.eval_hw)
            ref["flow_fwd"] = flow_between(sc.params, eh, ew, a, sc.times[temporal[0]],
                                           sc.c2w(temporal[1]), sc.times[temporal[1]])
        for k, v in ref.items():
            gaps.append(rel(bf16(v), v) if low else rel(item[k], v))
        masks = np.concatenate([np.stack([rr.half_mask(raw[g]["dyn_mask"])[..., None]
                                          for g in ids]) for ids in (spatial, temporal)])
        got = np.concatenate([item["dyn_mask_src_spatial"], item["dyn_mask_src_temporal"]])
        tgt = rr.half_eval_mask(raw[f]["dyn_mask"])[..., None]
        if not low:
            gaps.append(float(np.any(got != masks)
                              or np.any(item["misc"]["tgt_dyn_mask"] != tgt)))
        return max(gaps)


def _pixel_gaps(got, ref):
    """The 90th percentile and the RMS of the pixel gaps of the contract's
    images (the sources' and the target's) from the written frames."""
    import numpy as np

    d = np.abs(np.asarray(got, np.float64) - ref)
    return {"reader_rgb": float(np.quantile(d, 0.9)),
            "reader_rgb_rms": float(np.sqrt(np.mean(d * d)))}


def _score_gaps(got, ref):
    """Largest relative gap of the PSNR / SSIM scores, and of LPIPS."""
    def gap(keys):
        vals = [abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in keys if k in ref]
        return max(vals) if vals else 0.0

    keys = [k for k in ref if k.startswith(("psnr_", "ssim_"))]
    return {"score_psnr_ssim": gap(keys), "score_lpips": gap([k for k in ref if "lpips" in k])}
