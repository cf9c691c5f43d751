"""Faults planted in the timed path, to show that the check fails them
(``tools/readings.py --fault``, the tests): ``alter_answer`` offsets the
static layer and the composite of one view by 0.05 where they are produced;
``half_sources`` leaves out half of a view's spatial sources."""

SPATIAL = ("rgb_src_spatial", "dyn_mask_src_spatial", "flat_cam_src_spatial")


def on_data(fault, data):
    """The contract a view is rendered from."""
    if fault != "half_sources":
        return data
    v = data["rgb_src_spatial"].shape[0] // 2
    return {**data, **{k: data[k][:v] for k in SPATIAL}}


def on_output(fault, out, altered):
    """The render's outputs; ``altered``: whether this is the view the fault
    alters."""
    if fault != "alter_answer" or not altered:
        return out
    return {**out, "static_coarse_rgb": out["static_coarse_rgb"] + 0.05,
            "combined_rgb": out["combined_rgb"] + 0.05}
