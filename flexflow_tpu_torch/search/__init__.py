"""The Unity search's machine model and the plain rules of its
update-sharding decision (`unity.choose_update_sharding`): a first piece
of the twin of `flexflow_tpu/search/`; the rest is ROADMAP A7."""
