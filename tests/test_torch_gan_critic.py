"""The port's GAN critic loss against jitted `jax.value_and_grad` of the JAX
package's, in value and in every gradient leaf of the (fake score, GAN
head) pair at REL = 1e-3, on tests/test_torch_gan.py's networks, heads and
replayed draws (`check_critic`): the standard adversarial loss with R1 and
R2, and the branch without a real latent."""
import pytest

from test_torch_gan import check_critic
from test_torch_training import nets  # noqa: F401


@pytest.mark.parametrize("overrides,with_real", [
    (dict(r1_weight=0.5, r2_weight=0.7), True),
    (dict(r1_weight=0.5, r2_weight=0.7), False),
], ids=["standard_r1_r2", "no_real_latent"])
def test_critic_loss_and_grads(nets, overrides, with_real):  # noqa: F811
    check_critic(nets, overrides, with_real)
