"""Alias of the reference's ``open_universe.networks.universe``."""
from ..models.condition import ConditionerNetwork, MelAdapter  # noqa: F401
from ..models.discriminators import (  # noqa: F401
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from ..models.mdn import MixtureDensityNetworkLoss  # noqa: F401
from ..models.score import ScoreNetwork  # noqa: F401
from ..models.universe import Universe  # noqa: F401
from ..models.universe_gan import UniverseGAN  # noqa: F401
