"""The JAX reference's sharded MoE dispatch (``moe_mlp_sharded``) on a
(data 2, model 2) mesh of forced host devices, for
tests/test_torch_moe_dispatch.py.

Run as ``XLA_FLAGS=--xla_force_host_platform_device_count=4 python
tests/torch_moe_reference.py <in.npz> <out.npz>`` (the test does): the
input holds the MoE layer's parameters and each case's rows and
cotangent; the output, for every case, the reference's y, aux and the
gradients of ``sum(y * r) + aux`` with respect to x and every parameter,
through its sharded call, and the same of its single-device call. This
module imports JAX and the reference only (pytest's process is locked to
one device).
"""
import dataclasses
import sys

import numpy as np

# name -> (rows, capacity factor, ep_major): the reference's three branches
# at a capacity that binds (1.25) and at one that does not (8.0)
CASES = {f"{branch}-{cf}": (t, cf, ep) for branch, t, ep in
         (("large", 64, False), ("decode", 4, False), ("ep", 64, True))
         for cf in (1.25, 8.0)}
D_MODEL, N_EXPERTS, TOP_K, D_FF, N_SHARED = 32, 8, 2, 64, 1
MESH = (2, 2)


def main(src, dst):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.config import MoEConfig
    from repro.distributed import sharding as shd
    from repro.models import moe as moe_mod

    got = np.load(src)
    params = {k[len("p/"):]: jnp.asarray(v) for k, v in got.items() if k.startswith("p/")}
    p = {"router": {"w": params["router/w"]}, "wi_gate": params["wi_gate"],
         "wi_up": params["wi_up"], "wo": params["wo"],
         "shared": {n: {"w": params[f"shared/{n}/w"]} for n in ("wi_gate", "wi_up", "wo")}}
    # Auto axes: the GSPMD semantics the reference was written for (the
    # default Explicit axes refuse its shared experts' parameter gradient)
    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for name, (t, cf, ep) in CASES.items():
        mcfg = MoEConfig(n_experts=N_EXPERTS, top_k=TOP_K, n_shared_experts=N_SHARED,
                         expert_d_ff=D_FF, capacity_factor=cf)
        sm = dataclasses.replace(mcfg, dispatch="shard_map")
        x, r = jnp.asarray(got[f"x/{name}"]), jnp.asarray(got[f"r/{name}"])
        shard = shd.make_shard_fn(mesh, ep_major=ep)

        def loss(pp, xx, mc, sh):
            y, aux = moe_mod.moe_mlp(pp, xx, mc, "swiglu", sh)
            return jnp.sum(y * r) + aux, (y, aux)

        grad = jax.grad(loss, argnums=(0, 1), has_aux=True)
        for tag, mc, sh in (("single", mcfg, None), ("sharded", sm, shard)):
            if sh is None:
                (gp, gx), (y, aux) = jax.jit(lambda pp, xx: grad(pp, xx, mc, None))(p, x)
            else:
                with mesh:
                    spec = P(("data", "model"), None) if ep else P("data", "model")
                    xs = jax.device_put(x, NamedSharding(mesh, spec))
                    (gp, gx), (y, aux) = jax.jit(lambda pp, xx: grad(pp, xx, mc, sh))(p, xs)
            pre = f"{tag}/{name}"
            out[f"{pre}/y"], out[f"{pre}/aux"] = np.asarray(y), np.asarray(aux)
            out[f"{pre}/dx"] = np.asarray(gx)
            out[f"{pre}/g/router/w"] = np.asarray(gp["router"]["w"])
            for n in ("wi_gate", "wi_up", "wo"):
                out[f"{pre}/g/{n}"] = np.asarray(gp[n])
                out[f"{pre}/g/shared/{n}/w"] = np.asarray(gp["shared"][n]["w"])
    np.savez(dst, **out)
    print("torch_moe_reference OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
