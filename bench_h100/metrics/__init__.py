"""One reader a metric: ``<metric>.py`` holds ``read(ctx)``, which returns
the metric's number, or None where the run has nothing to read."""
