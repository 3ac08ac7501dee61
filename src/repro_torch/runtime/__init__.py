"""Runtime substrate: the paged KV block manager and the synthetic
serving workload."""
