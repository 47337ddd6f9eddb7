"""NCBI taxonomy and the set-targets workflow (counterpart of
`cuclark_tpu/taxonomy/`)."""
