from portbench.spans import huge_ingest_wait_ms as read  # noqa: F401
