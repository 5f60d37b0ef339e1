"""Command-line launchers of the port, after ``repro.launch``:
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve`` (host mode, one card or the CPU).
The production-mesh paths (``--mesh pod|multipod``, ``--dry-run``) need
more than one device and raise (ROADMAP A8.4)."""
