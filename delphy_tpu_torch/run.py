"""The MCMC ``Run`` (port of the blocking ``Run`` of ``delphy_tpu/run.py``:
exponential population model, one device).

Owns the device state and the step/cadence bookkeeping.  Each
``do_mcmc_steps`` call runs dispatches of partitioned boundaries (global
moves + local sweep) on the run's device, and host topology bursts through
the port's native C++ topology kernel (``native/``).  The host syncs where the
reference ``Run`` does: draining the attempted-move counts and fetching the
fused state bundle at a burst.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from . import DEFAULT_DEVICE, DTYPE, resolve_device
from . import pop as popm
from .convert import part_maps_to_torch
from .evo import EvoParams, make_evo_params
from .mcmc import global_moves as gm
from .mcmc.global_moves import PriorConfig
from .mcmc.kernel import boundary_grid_bounds
from .mcmc.moves import Ledger
from .native import native_available, run_burst_native
from .ops import coalescent as coal
from .ops import likelihood as lk
from .parallel.partmaps import (auto_num_partitions, build_part_maps,
                                host_mut_nodes, pad_part_maps, part_size_cap)
from .parallel.sweep import NB_MAX, parts_multi_super_step
from .phylo import FlatTree, rereference_to_root_sequence
from .state import TreeState, fetch_fused, fetch_one, pack_state, \
    split_for_host, unpack_state
from .topo.mixer import HostCoalGrid, HostExpPop
from .topo.parallel import run_partitioned_bursts
from .topo.reform import resample_multi_site_chains

# Dispatch cap: at most this many local moves of boundaries per dispatch.
MAX_DISPATCH_MOVES = 32_000_000
# Boundaries between periodic restencils (the reference's stencil refresh,
# run.cpp:87-108).
RESTENCIL_INTERVAL = 200


def _round_cap(n: int) -> int:
    return (max(n, 64) + 127) // 128 * 128


def _round16(n: int) -> int:
    return (max(n, 16) + 15) // 16 * 16


class HostView(NamedTuple):
    """What the I/O layer reads of a run, on the host: ``evo`` and ``pop``
    with numpy leaves, the ledger's terms as numpy floats (None before the
    first dispatch), the node times, the root and the last boundary's
    mutation count."""
    evo: EvoParams
    pop: popm.ExpPopParams
    ledger: Ledger | None
    t: np.ndarray
    root: int
    num_muts: int | None


def calc_ledger(ts: TreeState, evo, pop_params, t_max_tip, num_cells: int,
                hyp: PriorConfig) -> Ledger:
    """From-scratch ledger recompute under the current parameters."""
    caches = gm.compute_caches(ts, evo)
    log_G = lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq)
    t_lo, t_step = boundary_grid_bounds(ts, t_max_tip, num_cells)
    grid = coal.make_grid(pop_params, ts.t, ts.is_tip, t_lo, t_step,
                          num_cells)
    log_coal = coal.calc_log_prior(grid, pop_params, ts.t, ts.is_tip)
    log_other = gm.calc_log_other_priors(evo, pop_params, hyp)
    return Ledger(log_G=log_G, log_coal=log_coal, log_other=log_other)


class Run:
    def __init__(self, tree: FlatTree, seed: int = 0,
                 hyp: PriorConfig = PriorConfig(), num_cells: int = 512,
                 local_moves_per_global_move: int = -1,
                 topology_moves_enabled: bool = True,
                 topology_partitions: int = 0,
                 device_partitions: int = 0, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if hyp.mpox_enabled or hyp.alpha_move_enabled:
            raise NotImplementedError("mpox and alpha/nu moves are not ported")
        if topology_moves_enabled:
            # the port has no Python topology mixer to fall back to
            if not native_available():
                raise RuntimeError("topology moves need the native topology "
                                   "kernel (g++), which failed to build")
        tree.check_integrity()
        tree = tree.copy()  # the Run owns its tree: bursts mutate it
        self.names = list(tree.name)
        n_muts = tree.num_mutations() + len(tree.mutations[tree.root])
        self.mut_capacity = _round_cap(2 * n_muts + 256)
        n_ivs = sum(len(iv) for iv in tree.miss_intervals)
        self.miss_capacity = _round_cap(2 * n_ivs + 128)
        n_fs = sum(len(fs) for fs in tree.miss_from_states)
        self.fs_capacity = _round_cap(4 * n_fs + 128)
        self.ts: TreeState = pack_state(tree, self.mut_capacity,
                                        self.miss_capacity, self.fs_capacity,
                                        device=self.device)
        # fused (ints, floats) copy of (ts, evo, pop) from the last dispatch;
        # None whenever host code has since replaced any of the three
        self._fused_bundle = None
        self.hyp = hyp
        self.num_cells = num_cells
        self.topology_moves_enabled = topology_moves_enabled
        self.topology_partitions = topology_partitions
        self._topo_debt = 0
        self.host_rng = np.random.default_rng(np.uint64(seed)
                                              + 0x9E3779B97F4A7C15)
        self.topology_accepted = 0
        self.topology_proposed = 0
        self.dispatch_count = 0
        self.burst_count = 0
        N = self.ts.num_nodes
        self.local_moves_per_global_move = (
            50 * N if local_moves_per_global_move == -1
            else local_moves_per_global_move)
        lm = max(1, self.local_moves_per_global_move)
        self.topology_burst_chunks = (max(2, min(256, 2_000_000 // lm))
                                      if lm <= 2_000_000 else 32)

        # initial HKY pi from ref-sequence state frequencies (run.cpp:61-80)
        freq = np.bincount(np.asarray(tree.ref_seq),
                           minlength=4).astype(np.float64)
        est_pi = freq / freq.sum()
        if est_pi.min() < 0.01 or est_pi.max() > 0.99:
            est_pi = np.full(4, 0.25)
        self.evo = make_evo_params(tree.num_sites, mu=1e-3 / 365.0, kappa=1.0,
                                   pi=est_pi, alpha=10.0, device=self.device)
        t_max_tip = float(np.max(tree.t_max[:tree.num_tips]))
        self.t_max_tip = t_max_tip

        def f(x):
            return torch.tensor(x, dtype=DTYPE, device=self.device)
        # Exp(t0 = max tip time, n0 = 1000, g = 0, min_pop = 1) (run.cpp:21)
        self.pop = popm.ExpPopParams(t0=f(t_max_tip), n0=f(1000.0), g=f(0.0),
                                     min_pop=f(1.0))
        self._set_euler(tree)

        self.device_partitions = (device_partitions if device_partitions > 0
                                  else auto_num_partitions(tree.num_tips))
        self._host_tree = tree          # topology/t synced at repartition
        self._n_cap_sticky = 0
        self._m_cap_sticky = 0
        self._P_sticky = 0
        self.pm = None
        self._boundaries_since_repart = 0
        self._repartition()

        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.step = 0
        self._attempted_done = 0
        # dispatch results not yet drained: (count tensor, done event or
        # None, boundaries, n_blocks)
        self._inflight: list = []
        self.ledger: Ledger | None = None
        self.last_stats = None

    def _set_euler(self, tree: FlatTree):
        tin, tout = tree.euler_positions()
        self.tin = torch.as_tensor(np.asarray(tin), device=self.device)
        self.tout = torch.as_tensor(np.asarray(tout), device=self.device)

    # -- lazy attempted-move accounting -------------------------------------

    def _absorb(self, arr, boundaries: int, n_blocks: int):
        """Count one dispatch's attempted moves (a host sync) and feed the
        measured moves-per-block rate that sizes later dispatches."""
        attempted = int(arr)
        self._attempted_done += attempted
        measured = attempted / (boundaries * n_blocks)
        self._per_block_rate = max(
            1.0, 0.7 * self._per_block_rate + 0.3 * measured)

    def _drain_inflight(self, block: bool = True):
        keep = []
        for arr, done, boundaries, n_blocks in self._inflight:
            if not block and done is not None and not done.query():
                keep.append((arr, done, boundaries, n_blocks))
                continue
            self._absorb(arr, boundaries, n_blocks)
        self._inflight = keep

    @property
    def local_moves_attempted(self) -> int:
        self._drain_inflight(block=True)
        return self._attempted_done

    @local_moves_attempted.setter
    def local_moves_attempted(self, v: int):
        self._inflight.clear()
        self._attempted_done = v

    def _repartition(self, sync_times: bool = False):
        """(Re)build the device partition maps from the current tree
        (Run::repartition, run.cpp:110-190), with the same host draws and
        sticky capacities as the reference package's ``Run``."""
        tree = self._host_tree
        if sync_times:
            tree.t = self.ts.t.cpu().numpy().astype(np.float64).copy()
        P = self.device_partitions
        pm, self._last_cuts = build_part_maps(
            tree, host_mut_nodes(tree, self.mut_capacity), P, self.host_rng,
            return_cuts=True)
        if self._P_sticky < P:
            self._P_sticky = P
        if pm.num_parts > self._P_sticky:
            self._P_sticky = (int(1.1 * pm.num_parts) + 7) // 8 * 8
        P = self._P_sticky
        if self._n_cap_sticky == 0:
            self._n_cap_sticky = _round16(int(1.4 * pm.n_cap) + 16)
            if P > 1:
                # the oversized-part splitter bounds every stencil's worst
                # part at part_size_cap()
                hard = _round16(max(part_size_cap(), pm.n_cap))
                self._n_cap_sticky = min(self._n_cap_sticky, hard)
            self._m_cap_sticky = _round16(2 * pm.m_cap + 16)
        if pm.n_cap > self._n_cap_sticky:
            self._n_cap_sticky = _round16(int(1.5 * pm.n_cap))
        if pm.m_cap > self._m_cap_sticky:
            self._m_cap_sticky = _round16(int(1.5 * pm.m_cap))
        pm = pad_part_maps(pm, P, self._n_cap_sticky, self._m_cap_sticky,
                           tree.num_nodes, self.mut_capacity)
        self.pm = part_maps_to_torch(pm, self.device)
        n_cap = self._n_cap_sticky
        if not hasattr(self, "_per_block_rate") or self._per_block_rate <= 1.0:
            self._per_block_rate = float(self.device_partitions
                                         * (1 + n_cap // 4 + n_cap // 2))

    # -- parameter setters (subset of the reference's Run API) --------------

    def _scalar(self, x) -> torch.Tensor:
        return torch.tensor(float(x), dtype=DTYPE, device=self.device)

    def set_mu(self, mu: float):
        self.evo = self.evo._replace(mu=self._scalar(mu))
        self._fused_bundle = None

    def set_alpha(self, alpha: float):
        self.evo = self.evo._replace(alpha=self._scalar(alpha))
        self._fused_bundle = None

    def set_pop(self, n0=None, g=None, min_pop=None):
        given = {k: self._scalar(v) for k, v in
                 (("n0", n0), ("g", g), ("min_pop", min_pop)) if v is not None}
        self.pop = self.pop._replace(**given)
        self._fused_bundle = None

    # -- MCMC ---------------------------------------------------------------

    def do_mcmc_steps(self, n_steps: int):
        """Advance n_steps local moves, interleaving global boundaries at the
        configured cadence (Run::do_mcmc_steps, run.cpp:622-657); topology
        moves run as host bursts at dispatch ends."""
        done = 0
        cadence = self.local_moves_per_global_move
        K = self.topology_burst_chunks
        P = self.device_partitions
        k_cap = max(1, min(K, MAX_DISPATCH_MOVES // max(1, cadence)))
        if P > 1:
            k_cap = min(k_cap, RESTENCIL_INTERVAL)
        while done < n_steps:
            remaining = n_steps - done
            boundaries = max(1, min(k_cap, remaining // cadence))
            chunk = min(remaining, boundaries * cadence)
            per_boundary = (chunk + boundaries - 1) // boundaries
            n_blocks = max(1, min(NB_MAX,
                                  round(per_boundary / self._per_block_rate)))
            (self.ts, self.evo, self.pop, self.ledger, self.last_stats,
             self._fused_bundle) = parts_multi_super_step(
                self.ts, self.evo, self.pop, self.gen, self.tin, self.tout,
                self.pm, n_blocks, self.t_max_tip, self.hyp, self.num_cells,
                boundaries)
            self.dispatch_count += 1
            done_event = None
            if self.device.type == "cuda":
                done_event = torch.cuda.Event()
                done_event.record()
            self._inflight.append((self.last_stats["local_moves_attempted"],
                                   done_event, boundaries, n_blocks))
            self._drain_inflight(block=False)
            while len(self._inflight) > 3:
                arr, _ev, b_, nb_ = self._inflight.pop(0)
                self._absorb(arr, b_, nb_)
            self._boundaries_since_repart += boundaries
            repartitioned = False
            if self.topology_moves_enabled:
                self._topo_debt += int(self.host_rng.binomial(chunk,
                                                              2.0 / 30.0))
                threshold = max(32, K * int(cadence * 2.0 / 30.0))
                flush = (done + chunk >= n_steps
                         and self._topo_debt
                         >= max(32, int(cadence * 2.0 / 30.0)))
                if self._topo_debt >= threshold or flush:
                    self._topology_burst(self._topo_debt)
                    self._attempted_done += self._topo_debt
                    self._topo_debt = 0
                    repartitioned = True
            if (not repartitioned and P > 1
                    and self._boundaries_since_repart
                    >= RESTENCIL_INTERVAL):
                self._repartition(sync_times=True)
            if (repartitioned
                    or self._boundaries_since_repart
                    >= RESTENCIL_INTERVAL):
                self._boundaries_since_repart = 0
            done += chunk
        self.step += n_steps

    def _topology_num_parts(self) -> int:
        if self.topology_partitions > 0:
            return self.topology_partitions
        T = self.ts.num_tips
        return max(1, min(2 * (os.cpu_count() or 1), T // 10),
                   min(1024, T // 100))

    def _topology_burst(self, n_moves: int):
        # one fused device->host transfer for everything the burst needs
        if self._fused_bundle is not None:
            ints, flts = self._fused_bundle
            ts_h, evo_h, pop_h = split_for_host(
                (self.ts, self.evo, self.pop), ints.cpu(), flts.cpu())
        else:
            ts_h, evo_h, pop_h = fetch_fused((self.ts, self.evo, self.pop))
        tree = unpack_state(ts_h, names=self.names)
        host_pop = HostExpPop(pop_h.t0, pop_h.n0, pop_h.g, pop_h.min_pop)
        mu, nu, q, pi = (float(evo_h.mu), np.asarray(evo_h.nu),
                         np.asarray(evo_h.q), np.asarray(evo_h.pi))
        part, q_tab = np.asarray(evo_h.part), np.asarray(evo_h.q_tab)
        num_cells = min(self.num_cells, 400)
        self.burst_count += 1

        P = self._topology_num_parts()
        if P > 1 and n_moves >= 16 * P:
            # partitioned phase: parts run on the native kernel's threads
            dlg, acc, prop = run_partitioned_bursts(
                tree, n_moves, P, host_pop, mu, nu, q, pi, self.host_rng,
                num_cells=num_cells, part=part, q_tab=q_tab)
            if self.ledger is not None:
                # the augmented per-part priors do not sum to the plain
                # prior: refresh log_coal from the post-burst tree
                hg = HostCoalGrid(tree, host_pop, num_cells, self.t_max_tip)
                self.ledger = self.ledger._replace(
                    log_G=self.ledger.log_G + dlg,
                    log_coal=torch.as_tensor(hg.log_prior(tree.t),
                                             dtype=DTYPE, device=self.device))
        else:
            res = run_burst_native(
                tree, n_moves, mu, nu, q, pi, host_pop,
                seed=int(self.host_rng.integers(2 ** 63)),
                can_change_root=True, num_cells=num_cells,
                t_max_tip=self.t_max_tip, part=part, q_tab=q_tab)
            if res is None:
                raise RuntimeError("native topology burst failed")
            dlg, dlc, acc, prop = res
            if self.ledger is not None:
                self.ledger = self.ledger._replace(
                    log_G=self.ledger.log_G + dlg,
                    log_coal=self.ledger.log_coal + dlc)
        self.topology_accepted += acc
        self.topology_proposed += prop
        # joint redraw of same-site mutation chains, the one slot class the
        # device reform cannot touch
        qa_tab = -np.diagonal(q_tab, axis1=1, axis2=2)
        window = n_moves * 30.0 / 2.0
        rounds = max(1, round(window / max(1, self.local_moves_per_global_move)))
        dlg_chains = resample_multi_site_chains(tree, self.host_rng, mu, nu,
                                                part, qa_tab, rounds=rounds)
        if self.ledger is not None and dlg_chains != 0.0:
            self.ledger = self.ledger._replace(
                log_G=self.ledger.log_G + dlg_chains)
        # keep the reference sequence anchored at the root (log_G invariant)
        rereference_to_root_sequence(tree)

        n_muts = tree.num_mutations() + len(tree.mutations[tree.root])
        while n_muts > self.mut_capacity - 8:
            self.mut_capacity = _round_cap(2 * self.mut_capacity)
        n_ivs = sum(len(iv) for iv in tree.miss_intervals)
        while n_ivs > self.miss_capacity - 8:
            self.miss_capacity = _round_cap(2 * self.miss_capacity)
        n_fs = sum(len(fs) for fs in tree.miss_from_states)
        while n_fs > self.fs_capacity - 8:
            self.fs_capacity = _round_cap(2 * self.fs_capacity)
        self.ts = pack_state(tree, self.mut_capacity, self.miss_capacity,
                             self.fs_capacity, device=self.device)
        self._fused_bundle = None
        self._set_euler(tree)
        # the burst changed topology and repacked the pool: rebuild the maps
        self._host_tree = tree
        self._repartition()

    # -- observability --------------------------------------------------------

    @property
    def log_posterior(self) -> float:
        return float(self.ledger.log_posterior)

    def tree(self) -> FlatTree:
        return unpack_state(fetch_fused(self.ts), names=self.names)

    def calc_cur_ledger(self) -> Ledger:
        """Full from-scratch recompute of the ledger under the current
        parameters (run.cpp:316-338)."""
        return calc_ledger(self.ts, self.evo, self.pop,
                           torch.tensor(self.t_max_tip, dtype=DTYPE,
                                        device=self.device),
                           self.num_cells, self.hyp)

    def check_derived_quantities(self, tol: float = 1e-6):
        """The incrementally maintained log_G must match a full recompute
        (run.cpp:316-338)."""
        if self.ledger is None:
            return
        got = float(self.ledger.log_G)
        want = float(self.calc_cur_ledger().log_G)
        if not abs(got - want) < tol:
            raise AssertionError(f"log_G drift: {got} != {want}")

    def host_view(self) -> HostView:
        """``evo``, ``pop``, the ledger, the node times and the root on the
        host, in one device-to-host copy.  Host code (log and snapshot
        writers, the server's getters) reads a run's parameters through this
        instead of field by field: each ``float()`` of a device scalar is a
        sync of its own."""
        ledger = self.ledger if self.ledger is not None else ()
        muts = (self.last_stats["num_muts"],) if self.last_stats else ()
        evo, pop, led, t, root, muts = fetch_one(
            (self.evo, self.pop, ledger, self.ts.t, self.ts.root, muts))
        return HostView(evo=evo, pop=pop, ledger=led or None, t=t,
                        root=int(root),
                        num_muts=int(muts[0]) if muts else None)

    def stats_line(self, hv: HostView | None = None) -> str:
        hv = hv or self.host_view()
        led, pi = hv.ledger, hv.evo.pi
        return (f"step {self.step}  log_post {float(led.log_posterior):.4f}  "
                f"log_G {float(led.log_G):.4f}  "
                f"log_coal {float(led.log_coal):.4f}  "
                f"muts {hv.num_muts}  "
                f"mu {float(hv.evo.mu) * 365.0:.3e}/yr  "
                f"kappa {float(hv.evo.kappa):.3f}  "
                f"pi [{pi[0]:.2f} {pi[1]:.2f} {pi[2]:.2f} {pi[3]:.2f}]  "
                f"n0 {float(hv.pop.n0):.2f}  "
                f"g {float(hv.pop.g) * 365.0:.3f}/yr  "
                f"t_root {float(hv.t[hv.root]):.2f}")
