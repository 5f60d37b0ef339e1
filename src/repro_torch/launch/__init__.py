"""Command-line launchers of the port, after ``repro.launch``:
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve`` (host mode, one card or the CPU),
and the dry run ``python -m repro_torch.launch.dryrun`` on one chip or
per chip of a production mesh (``specs``: the inputs on ``meta``), and
the meshes of a world of ranks (``mesh``: ``make_dev_mesh``,
``make_fleet_mesh``, ``make_production_mesh``).  The launchers' pod
mode (``--mesh pod|multipod``) prints the production-mesh count's keys,
as the reference's does; ``--dry-run`` in host mode serves or trains as
usual."""
