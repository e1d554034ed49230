"""``fleet`` (counterpart of the reference's ``distributed/fleet``): only
``utils.recompute`` is ported; the fleet's strategies, elastic training
and meta-optimizers are not."""
from . import utils  # noqa: F401
