"""The port's relativistic GAN critic loss (softplus(-(real - fake))) with R1
and R2 against jitted `jax.value_and_grad` of the JAX package's, in value
and in every gradient leaf at REL = 1e-3 (tests/test_torch_gan.py's
`check_critic`)."""
from test_torch_gan import check_critic
from test_torch_training import nets  # noqa: F401


def test_relativistic_critic_loss_and_grads(nets):  # noqa: F811
    check_critic(nets, dict(relativistic_discriminator=True, r1_weight=0.5, r2_weight=0.7),
                 True)
