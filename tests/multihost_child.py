"""Child process for the 2-process jax.distributed CPU test
(tests/test_parallel.py::test_two_process_distributed_render).

Each process: initialize -> global 8-device mesh (4 local CPU devices x 2
processes) -> replicate the scene -> run the sharded frame step -> save the
rows this host owns.  The parent combines both hosts' rows and asserts
bit-identity with the single-process sharded render.

Usage: python multihost_child.py <process_id> <num_processes> <port> <out.npz>
"""

import os
import sys

pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402

# Multi-process CPU collectives: gloo over the coordination service; the
# device count must come from jax_num_cpu_devices (xla_force_host_platform_
# device_count is not consulted by the distributed CPU client).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_num_cpu_devices", 4)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import tpu_pathtracer as pt  # noqa: E402
from tpu_pathtracer.parallel import multihost, sharded  # noqa: E402
from tpu_pathtracer.parallel.mesh import make_mesh  # noqa: E402
from tpu_pathtracer.scene.envmap import gradient_sky  # noqa: E402
from tpu_pathtracer.scene.types import Camera, RenderParams  # noqa: E402

multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
assert multihost.is_multihost()
assert len(jax.devices()) == 4 * nproc

mesh = make_mesh(tiles=8, samples=1)
scene = multihost.replicate(mesh, pt.default_scene(gradient_sky(16, 32)).compile())
cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
params = multihost.replicate(mesh, RenderParams.create(cam, frame=1))

step = sharded.make_sharded_frame_step(mesh, width=16, height=16, aspect=1.0)
acc = step(scene, params, sharded.zeros_acc(mesh, 16, 16))
present, data = multihost.fetch_rows(acc)
np.savez(out, present=present, data=data)
print(f"proc {pid}: ok rows={int(present.sum())}", flush=True)
