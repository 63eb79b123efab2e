"""The benchmark's harness: finding cells by name (spec), driving a
cell's window and check (session), the traced run's device trace
(devtrace) and the faults its own tests plant (faults)."""
