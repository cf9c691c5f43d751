"""Host ms per item in scoring: the host clock around ``Evaluator._score``
(PSNR / SSIM on the host, LPIPS on the card, the pickle)."""


def install(ctx, drv):
    ctx.spans.wrap(drv.ev, "_score", "score", on_device=False)


def read(ctx):
    ms = ctx.spans.host_ms("score")
    return None if ms is None else ms / ctx.spans.count("score")
