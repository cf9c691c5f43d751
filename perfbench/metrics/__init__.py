"""One reader per metric, named as in BENCHMARK.json: ``read(ctx)`` gives
the value or None (nothing to read: the metric is left out of the line);
``install(ctx, driver)``, where present, sets up the spans it reads before
the window of a traced run."""
