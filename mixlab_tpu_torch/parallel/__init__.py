"""Batched execution of one patch over a leading instance axis on one card
(port of ``mixlab_tpu/parallel/``): the fleet (``fleet.py``) and stems
(``stems.py``).  Sharding over several devices waits for its ROADMAP.md item
(queue 1, Multi-device)."""

MULTI_DEVICE = (
    "running over several devices (a mesh) is not ported to mixlab_tpu_torch yet: "
    "ROADMAP.md queue 1, Multi-device")


def one_device(device, mesh=None):
    """The single device of a batched path: ``mesh`` or a sequence of more
    than one device raises ``NotImplementedError`` naming the ROADMAP item."""
    if mesh is not None:
        raise NotImplementedError(MULTI_DEVICE)
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise NotImplementedError(MULTI_DEVICE)
        device = device[0]
    return device
