"""LM substrate of the port (the counterpart of ``repro.models``).

Import :func:`repro_torch.models.api.build_model` for the uniform interface.
(Not re-exported here to keep config <-> model imports acyclic.)
"""
