"""The Unity search's machine model (a first piece of the twin of
`flexflow_tpu/search/`; the rest is ROADMAP A7)."""
