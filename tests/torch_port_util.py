"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: JAX pytrees by key path, and weights moved across by those paths;
importing it sets the worker's torch threads to one."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from audiolm_pytorch_tpu_torch.weights import state_dict_from_jax

# Several test workers share the cores. At torch's default of one intra-op
# thread a core each worker's threads spin while they wait and stall the
# other workers (the SoundStream trainer's two-step loop took 95 s in a
# 6-worker run on 8 cores, 2 s alone); every test module of the port
# imports this one, so its worker computes on one thread.
torch.set_num_threads(1)


def jax_named(tree):
    """{key path: numpy array} of a JAX module's leaves."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def jax_replace(tree, new):
    """`tree` with the leaves named in `new` ({key path: array}) replaced."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for p, x in flat:
        name = jax.tree_util.keystr(p)
        leaves.append(jnp.asarray(new[name], dtype=x.dtype) if name in new else x)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def randomize_dynamic(tree, rng, scale=0.5):
    """Give every hyper-connection's dynamic alpha/beta weights nonzero random
    values (they are zero at init, which would hide them from a test)."""
    new = {}
    for name, a in jax_named(tree).items():
        if "dyn_alpha_w" in name or "dyn_beta_w" in name:
            new[name] = rng.normal(size=a.shape).astype(np.float32) * scale
        elif "dyn_alpha_scale" in name or "dyn_beta_scale" in name:
            new[name] = np.float32(rng.uniform(0.2, 0.5))
    return jax_replace(tree, new)


def load_into(port_module, jax_module):
    """Copy a JAX module's weights into its port counterpart (strict)."""
    port_module.load_state_dict(state_dict_from_jax(jax_named(jax_module)))
    return port_module


def t(a, dtype=None):
    """numpy -> torch on the CPU."""
    x = torch.from_numpy(np.asarray(a).copy())
    return x if dtype is None else x.to(dtype)
