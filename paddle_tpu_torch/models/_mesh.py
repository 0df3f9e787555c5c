"""The models' ``mesh`` parameter, taken at the JAX package's position."""

from paddle_tpu_torch.core.enforce import EnforceNotMet


def refuse_mesh(mesh, where):
    """``mesh=None`` runs on one device; any mesh raises: sharding over a
    mesh is not ported yet (ROADMAP queue 1 item 9)."""
    if mesh is not None:
        raise EnforceNotMet(
            f"{where}: mesh={mesh!r} is not ported yet (ROADMAP queue 1 "
            "item 9: the models' mesh and sharding); pass mesh=None to run "
            "on one device")
