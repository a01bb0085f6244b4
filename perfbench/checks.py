"""What decides ``correct``: the program's outputs on the timed path,
recorded while it runs, judged afterwards by the plain reference.

``Probe`` records, from outside the program:

* a sample of the net's evaluations (inputs and the program's logits
  and value), with the weights they were made with: the bundle's, or in
  a training cell's window the learner's weights at the iteration's start
  (the actor's source), taken from its state when the first record of
  the iteration is made;
* a sample of searched roots: the position, the noise the search drew
  (Dirichlet, or Gumbel) and the program's answer (the root's visit
  counts, or Gumbel's improved policy);
* a sample of rows of ``env.vector.step`` calls (inputs and outputs);
* on the device, every searched root's faults: a root that is over, a
  visit total other than the budget, an illegal move, a greedy move
  other than the most visited, a sampled move with no visits, a policy
  target that is not a distribution over the empty cells;
* in a training cell: the learner's first steps in set-up (the rows and
  symmetries of each batch, which the benchmark draws and hands to the
  program's sampler, the batch the program built from them, the weights
  and the optimizer state), and in the window the games of a sample of
  envs and the ring rows written from them.

``judge`` then runs the reference on what was recorded and returns each
number compared. With ``control`` it also returns the same numbers for
the reference computed through float8 (e4m3) in the program's place.
"""

from __future__ import annotations

import random
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import learner as ref_learner
from perfbench.reference import net as ref_net
from perfbench.reference import rules as ref_rules
from perfbench.reference import search as ref_search

_FIELDS = ("board", "to_play", "last_move", "move_count", "done", "winner")
_RING = ("board", "to_play", "last_move", "pi", "z", "z_valid", "pi_valid")


def _games(state) -> List:
    """The reference's games of recorded env rows (``_FIELDS``)."""
    st = [x.cpu().numpy() for x in state]
    return [ref_rules.Game(st[0][i].copy(), int(st[1][i]), int(st[2][i]),
                           int(st[3][i]), bool(st[4][i]), int(st[5][i]))
            for i in range(st[0].shape[0])]


def _tv(p, q) -> np.ndarray:
    """Total variation between rows of two distributions (each row
    normalised to sum 1)."""
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    q = q / np.maximum(q.sum(-1, keepdims=True), 1e-30)
    return 0.5 * np.abs(p - q).sum(-1)


class Probe:
    def __init__(self, ctx):
        self.ctx = ctx
        self.kind = ctx.kind
        cap = ctx.mix["capture"]
        self.eval_p, self.eval_rows = cap["eval_p"], cap["eval_rows"]
        self.step_p, self.step_rows = cap["step_p"], cap["step_rows"]
        # searched roots: every `root_every`-th search (ply or move) of
        # the window, `root_rows` roots of it, `root_max` searches at most
        self.root_every, self.root_rows = cap["root_every"], cap["root_rows"]
        self.root_max = cap["root_max"]
        self.searches = 0
        self.rng = random.Random(ctx.seed * 7919 + 17)
        self.gen = torch.Generator().manual_seed(ctx.seed & (2 ** 62 - 1))
        self.active = False        # the window
        self.setup_phase = False   # a training cell's set-up iterations
        self.evals: List = []
        self.steps: List = []
        self.roots: List = []     # Gumbel roots, for the reference's root
        self.followed: List = []  # capped searches, for ``follow_capped``
        self.track: Optional[Dict] = None   # the capped search followed now
        self.noise = self.gumbel = None   # the search's last draws
        self.unit_faults: List[torch.Tensor] = []
        self._faults: Optional[torch.Tensor] = None
        # the actor's weights in a training cell's window: snapshots of the
        # learner's net, one an iteration in which something was recorded
        self.snapshots: List = []
        self._actor = None
        self._actor_key: Optional[int] = None
        # training cells
        self.learner: Dict = {"batches": [], "losses": [], "rows": [],
                              "samples": []}
        self.last_sample = None
        self.games: List = []      # per unit: list of per-ply records
        self.writes: List = []     # per unit: (unit, ptr before)
        self.ring_rows = None
        self.units = 0
        self.game_envs = None
        self.judged = {"env_steps": 0, "moves_played": 0, "ring_rows": 0,
                       "roots": 0}

    # -- recording --------------------------------------------------------

    def _rows(self, n: int, k: int, device) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen)[:k].to(device)

    def _eval_on(self) -> bool:
        return self.active or (self.kind.EVAL_IN_SETUP and self.setup_phase)

    def note_actor(self, net) -> None:
        """The learner's net an iteration's actor is built from."""
        self._actor, self._actor_key = net, None

    def _weights_key(self) -> Optional[int]:
        """None: the bundle's weights; else the snapshot of the learner's
        weights this iteration's actor was built from."""
        if not self.active or self._actor is None:
            return None
        if self._actor_key is None:
            self.snapshots.append(self.ctx.arch.program_trees(self._actor))
            self._actor_key = len(self.snapshots) - 1
        return self._actor_key

    def _pick_search(self) -> bool:
        """Whether the window's next search is one of those sampled."""
        if not self.active:
            return False
        self.searches += 1
        return ((self.searches - 1) % self.root_every == 0
                and self.searches <= self.root_every * self.root_max)

    def wrap_search(self, fn):
        """The capped search: on a sampled search, its roots' draws, net
        outputs, lanes' paths and visit counts are kept for
        ``follow_capped``."""
        def run(env_cfg, mcts_cfg, evaluate, state, generator=None, **kw):
            if not self._pick_search():
                return fn(env_cfg, mcts_cfg, evaluate, state, generator, **kw)
            live = torch.nonzero(~state.done)[:, 0]
            j = live[torch.randperm(len(live), generator=self.gen)[
                :self.root_rows].to(live.device)]
            self.track = {"J": j, "E": state.board.shape[0], "root": None,
                          "evals": [], "passes": []}
            try:
                res = fn(env_cfg, mcts_cfg, evaluate, state, generator, **kw)
            finally:
                track, self.track = self.track, None
            noise = kw.get("noise")
            if noise is None and kw.get("add_noise", True):
                noise = self.noise
            self.followed.append((
                tuple(getattr(state, f)[j] for f in _FIELDS),
                None if noise is None else noise[j].float(), track,
                res.visits[j].float(), mcts_cfg))
            return res
        return run

    def wrap_select(self, fn):
        def select(*args, **kw):
            out = fn(*args, **kw)
            if self.track is not None:
                j = self.track["J"]
                self.track["passes"].append(tuple(x[j] for x in out))
            return out
        return select

    def wrap_evaluate(self, fn):
        def evaluate(board, to_play, last):
            logits, value = fn(board, to_play, last)
            tr = self.track
            if tr is not None:
                if tr["root"] is None:
                    tr["root"] = logits[tr["J"]].float()
                else:
                    lb = board.shape[0] // tr["E"]
                    rows = (tr["J"][:, None] * lb + torch.arange(
                        lb, device=board.device)).reshape(-1)
                    tr["evals"].append((board[rows], to_play[rows],
                                        last[rows], logits[rows].float(),
                                        value[rows].float()))
            if self._eval_on() and self.rng.random() < self.eval_p:
                idx = self._rows(board.shape[0], self.eval_rows, board.device)
                self.evals.append((self._weights_key(), board[idx],
                                   to_play[idx], last[idx],
                                   logits[idx].float(), value[idx].float()))
            return logits, value
        return evaluate

    def wrap_step(self, fn):
        def step(cfg, state, action):
            out = fn(cfg, state, action)
            if self.active and self.rng.random() < self.step_p:
                idx = self._rows(state.board.shape[0], self.step_rows,
                                 state.board.device)
                self.steps.append(
                    tuple(getattr(state, f)[idx] for f in _FIELDS)
                    + (action[idx],)
                    + tuple(getattr(out, f)[idx] for f in _FIELDS))
            return out
        return step

    def wrap_draw(self, name: str):
        """Keeps the search's last random draw (`name`: noise, gumbel)."""
        def make(fn):
            def draw(*args, **kw):
                out = fn(*args, **kw)
                setattr(self, name, out)
                return out
            return draw
        return make

    def _acc(self, x: torch.Tensor) -> None:
        self._faults = x if self._faults is None else self._faults + x

    def observe(self, state, res, action):
        """Every root of a ply: its faults, summed on the device; of a
        Gumbel search, a sample of roots for the reference's root."""
        noise, g = self.noise, self.gumbel
        self.noise = self.gumbel = None
        if not self.active:
            return
        mcts = self.ctx.cfg.mcts
        a = action.long()[:, None]
        empty = state.board == 0
        faults = ((~empty.gather(1, a)[:, 0]).sum() + state.done.sum()
                  + (res.visits.sum(-1) != mcts.num_simulations).sum())
        gumbel = hasattr(res, "pi_target")
        if gumbel:
            pi = res.pi_target
            faults = faults + (~torch.isfinite(pi).all(-1)).sum() \
                + ((pi.sum(-1) - 1).abs() > 1e-4).sum() \
                + ((pi != 0) & ~empty).any(-1).sum()
            if self.game_envs is not None:
                j = self.game_envs
                self.games[-1].append(
                    (state.board[j], state.to_play[j], state.last_move[j],
                     state.move_count[j], action[j], pi[j]))
        else:
            top = res.visits.argmax(-1)
            greedy = self.kind.greedy(state, mcts)
            seen = res.visits.gather(1, a)[:, 0] > 0
            faults = faults + (greedy & (top != a[:, 0])).sum() \
                + (~greedy & ~seen).sum()
        self._acc(faults)
        if gumbel and self._pick_search():
            j = self._rows(state.board.shape[0], self.root_rows,
                           state.board.device)
            self.roots.append((
                self._weights_key(),
                tuple(getattr(state, f)[j] for f in _FIELDS),
                g[j].float(), res.pi_target[j].float()))

    def start_unit(self):
        if self.active and self.kind.RECORDS_GAMES:
            self.games.append([])

    def end_unit(self):
        if self.active:
            self.unit_faults.append(
                self._faults if self._faults is not None
                else torch.zeros((), dtype=torch.int64))
            self.units += 1
        self._faults = None

    def start_window(self, envs: Optional[int] = None):
        self.active = True
        if self.kind.RECORDS_GAMES:
            self.game_envs = self._rows(
                envs, self.ctx.mix["capture"]["game_envs"], self.ctx.device)

    # -- training ---------------------------------------------------------

    def watch_sampler(self, patches, buffer):
        """In set-up, the rows and symmetries of the learner's batches are
        drawn here, from the seed, and handed to the program's sampler;
        the ring's rows at them are kept for the reference."""
        probe = self
        steps = int(self.ctx.mix["checked_steps"])

        def make(fn):
            def sample(env, buf, batch_size, generator=None, *, idx=None,
                       sym=None):
                if (probe.setup_phase and idx is None and sym is None
                        and len(probe.learner["batches"]) < steps):
                    dev = buf.board.device
                    idx = torch.randint(0, max(int(buf.size), 1),
                                        (batch_size,),
                                        generator=probe.gen).to(dev)
                    sym = torch.randint(0, ref_learner.SYMMETRIES,
                                        (batch_size,),
                                        generator=probe.gen).to(dev)
                    probe.last_sample = (sym, tuple(
                        getattr(buf, f)[idx].clone() for f in _RING))
                return fn(env, buf, batch_size, generator, idx=idx, sym=sym)
            return sample
        patches.wrap(buffer, "sample", make)

    def watch_learner(self, patches, learner):
        probe, rec = self, self.learner
        steps = int(self.ctx.mix["checked_steps"])
        leaf = self.ctx.arch.leaf_name

        def make(fn):
            def train_step(env_cfg, net_cfg, train_cfg, ts, batch,
                           *args, **kw):
                n = len(rec["batches"])
                take = probe.setup_phase and n < steps
                if take:
                    if n == 0:
                        rec["p0"] = {leaf(k): v.detach().float().clone()
                                     for k, v in ts.net.named_parameters()}
                    rec["batches"].append([t.clone() for t in batch])
                    rec["samples"].append(probe.last_sample)
                    rec["rows"].append(int(batch[0].shape[0]))
                    probe.last_sample = None
                ts, aux = fn(env_cfg, net_cfg, train_cfg, ts, batch,
                             *args, **kw)
                if take:
                    rec["losses"].append(float(aux["loss"]))
                    if n == 0:
                        rec["mu1"] = {
                            leaf(k): m.detach().float().clone()
                            for (k, _), m in zip(ts.net.named_parameters(),
                                                 ts.opt_state.mu)}
                    rec["pK"] = {leaf(k): v.detach().float().clone()
                                 for k, v in ts.net.named_parameters()}
                return ts, aux
            return train_step
        patches.wrap(learner, "train_step", make)

    def after_iteration(self, carry, ptr_before: int) -> None:
        if self.active:
            self.writes.append((self.units, ptr_before))
        self._ring = carry.buffer

    def after_window(self) -> None:
        """Gather, before the program's state is freed, the ring rows
        written from the recorded games that are still in the ring."""
        if not self.kind.RECORDS_GAMES or not self.writes:
            return
        buf = self._ring
        cap = buf.board.shape[0]
        t_plies = self.ctx.cfg.train.selfplay_plies_per_iter
        envs = self.ctx.cfg.train.num_envs
        # rows of each write, in write order; a later write overwrites
        span = t_plies * envs
        last_row_owner = np.full(cap, -1, dtype=np.int64)
        for u, ptr in self.writes:
            rows = (ptr + np.arange(span)) % cap
            last_row_owner[rows] = u
        js = self.game_envs.cpu().numpy()
        want = []
        for u, ptr in self.writes:
            # unit u (window-relative) wrote the chunk of unit u - 1
            if u - 1 < 0 or u >= len(self.games) or not self.games[u - 1]:
                continue
            rows = [(ptr + t * envs + j) % cap for t in range(t_plies)
                    for j in js]
            if all(last_row_owner[r] == u for r in rows):
                want.append((u, rows))
        self.ring_rows = []
        for u, rows in want:
            idx = torch.tensor(rows, device=buf.board.device)
            self.ring_rows.append((u, buf.board[idx], buf.to_play[idx],
                                   buf.last_move[idx], buf.pi[idx],
                                   buf.z[idx], buf.z_valid[idx],
                                   buf.pi_valid[idx]))
        self._ring = None

    # -- judging ----------------------------------------------------------

    def judge(self, weights, control: bool = False) -> Dict:
        """{number: reading}; with `control` also {"control": {number:
        reading of the float8 reference in the program's place}}."""
        env = self.ctx.cfg.env
        out = {"search_faults": int(sum(int(f) for f in self.unit_faults)),
               "rule_faults": self._judge_steps(env)}
        out.update(self._judge_evals(weights, None))
        out.update(self._judge_roots(weights, None))
        out.update(self._judge_followed())
        if control:
            low = self._judge_evals(weights, ref_net.fp8)
            low.update(self._judge_roots(weights, ref_net.fp8))
            out["control"] = low
        if self.kind.RECORDS_GAMES:
            played, ring = self._judge_games(env)
            out["rule_faults"] += played
            out["ring_faults"] = ring
            out.update(self._judge_learner(weights, control, out))
        out["judged"] = dict(self.judged)
        return out

    def failed_units(self) -> int:
        return sum(int(f) > 0 for f in self.unit_faults)

    def _weights(self, weights, key):
        """(params, stats) as f32 tensors on the device: the bundle's
        (`key` None) or a snapshot of the learner's."""
        dev = self.ctx.device
        tree = weights if key is None else self.snapshots[key]
        return tuple(ref_net.tree_to_torch(t, dev) for t in tree)

    def _judge_evals(self, weights, quant) -> Dict:
        """policy_tv over every sampled evaluation; value_gap over those
        made in the bundle's weights. In a training window the value's
        sensitivity grows with the learner's steps, the float8 control's
        gap with it (both tens of times their set-up readings late in a
        window), so no one limit separates them there; the policy's
        does not grow, and it alone judges the actor against the
        learner's weights."""
        if not self.evals:
            return {"policy_tv": None, "value_gap": None}
        tv_max, gap_max, n = 0.0, None, 0
        for key in sorted({e[0] for e in self.evals}, key=str):
            p, s = self._weights(weights, key)
            cat = [torch.cat(x) for x in
                   zip(*(e[1:] for e in self.evals if e[0] == key))]
            board, to_play, last, logits, value = cat
            ref_logp, ref_value = self.ctx.arch.evaluate(
                p, s, self.ctx.cfg.env.board_size, board, to_play, last,
                quant=quant)
            legal = board == 0
            live = legal.any(-1)
            prog = ref_net.masked_log_softmax(logits, legal)
            tv = 0.5 * torch.where(legal, prog.exp() - ref_logp.exp(),
                                   0.0).abs().sum(-1)
            if live.any():
                tv_max = max(tv_max, float(tv[live].max()))
            if key is None:
                gap_max = float((value - ref_value).abs().max())
            n += int(board.shape[0])
        return {"policy_tv": tv_max, "value_gap": gap_max, "evaluations": n}

    def _ref_evaluate(self, p, s, quant):
        """The reference net as the reference searches call it."""
        size, dev = self.ctx.cfg.env.board_size, self.ctx.device
        arch = self.ctx.arch

        def evaluate(board, to_play, last):
            t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            logits, value = [], []
            for lo in range(0, board.shape[0], 1024):
                sl = slice(lo, lo + 1024)
                lg, v = arch.forward(p, s, arch.features(
                    size, t(board[sl]), t(to_play[sl]), t(last[sl])), quant)
                logits.append(lg.cpu().numpy())
                value.append(v.cpu().numpy())
            return np.concatenate(logits), np.concatenate(value)
        return evaluate

    def _judge_roots(self, weights, quant) -> Dict:
        """search_tv: the mean over the sampled Gumbel roots of the total
        variation between the program's improved policy and the
        reference root's on the same root and Gumbel draw, the reference
        net in the actor's weights."""
        if not self.roots:
            return {}
        cfg = self.ctx.cfg
        tvs = []
        for key in sorted({r[0] for r in self.roots}, key=str):
            rows = [r for r in self.roots if r[0] == key]
            evaluate = self._ref_evaluate(*self._weights(weights, key), quant)
            games, draws, answers = [], [], []
            for _, state, drawn, answer in rows:
                games += _games(state)
                draws.append(drawn.cpu().numpy())
                answers.append(answer.cpu().numpy())
            ref, _ = ref_search.gumbel_root(
                games, np.concatenate(draws), evaluate,
                ref_search.gumbel_config(cfg.env, cfg.mcts))
            tvs += _tv(np.concatenate(answers).astype(np.float64),
                       ref.astype(np.float64)).tolist()
        if quant is None:
            self.judged["roots"] = len(tvs)
        return {"search_tv": float(np.mean(tvs))}

    def _judge_followed(self) -> Dict:
        """descent_faults: the departures of the sampled capped searches
        from the reference's step-by-step account of them
        (``reference.search.follow_capped``)."""
        if not self.followed:
            return {"descent_faults": None}
        env, faults, roots = self.ctx.cfg.env, 0, 0
        for state, noise, track, visits, mcts in self.followed:
            np_ = lambda x: x.cpu().numpy()
            games = _games(state)
            k = len(games)
            passes = [dict(zip(("lps", "sel", "deps", "ppas"),
                               (np_(x) for x in sel)))
                      for sel in track["passes"]]
            evals = [[np_(x).reshape((k, -1) + tuple(x.shape[1:]))
                      for x in ev] for ev in track["evals"]]
            cfg = ref_search.search_config(env, mcts, noise is not None)
            for i, game in enumerate(games):
                rec = [dict({f: v[i] for f, v in sel.items()},
                            **dict(zip(("board", "to_play", "last", "logits",
                                        "value"), (x[i] for x in ev))))
                       for sel, ev in zip(passes, evals)]
                faults += ref_search.follow_capped(
                    game, None if noise is None else np_(noise[i]),
                    np_(track["root"][i]), rec, np_(visits[i]), cfg)
                roots += 1
        self.judged["roots"] = roots
        return {"descent_faults": faults}

    def _judge_steps(self, env) -> int:
        faults = 0
        n = len(_FIELDS)
        for rec in self.steps:
            rec = [t.cpu().numpy() for t in rec]
            before, action, after = rec[:n], rec[n], rec[n + 1:]
            for i in range(action.shape[0]):
                g = ref_rules.Game(before[0][i].copy(), int(before[1][i]),
                                   int(before[2][i]), int(before[3][i]),
                                   bool(before[4][i]), int(before[5][i]))
                a = int(action[i])
                if not g.done and g.board[a] != 0:
                    continue   # a lane the search discards (not judged)
                r = ref_rules.step(g, a, env.board_size, env.n_in_row,
                                   env.rules)
                self.judged["env_steps"] += 1
                got = [x[i] for x in after]
                faults += not (np.array_equal(got[0], r.board)
                               and int(got[1]) == r.to_play
                               and int(got[2]) == r.last
                               and int(got[3]) == r.count
                               and bool(got[4]) == r.done
                               and int(got[5]) == r.winner)
        return faults

    def _judge_games(self, env):
        """(played faults, ring faults) of the recorded envs' games."""
        s = env.board_size
        played = ring = 0
        plies = []       # per unit: list of per-ply numpy records
        for unit in self.games:
            plies.append([[t.cpu().numpy() for t in rec] for rec in unit])
        # the reference's outcome of every recorded move
        outcome = []
        for u, unit in enumerate(plies):
            outcome.append([])
            for t, (board, to_play, last, count, action, _) in \
                    enumerate(unit):
                res = []
                for j in range(action.shape[0]):
                    g = ref_rules.Game(board[j].copy(), int(to_play[j]),
                                       int(last[j]), int(count[j]), False, 0)
                    try:
                        r = ref_rules.step(g, int(action[j]), s,
                                           env.n_in_row, env.rules)
                    except ValueError:
                        played += 1
                        r = g
                    res.append(r)
                    nxt = (unit[t + 1] if t + 1 < len(unit) else
                           plies[u + 1][0] if u + 1 < len(plies)
                           and plies[u + 1] else None)
                    if nxt is None:
                        continue
                    self.judged["moves_played"] += 1
                    if r.done:
                        want = (np.zeros_like(r.board), 1, -1, 0)
                    else:
                        want = (r.board, r.to_play, r.last, r.count)
                    played += not (np.array_equal(nxt[0][j], want[0])
                                   and int(nxt[1][j]) == want[1]
                                   and int(nxt[2][j]) == want[2]
                                   and int(nxt[3][j]) == want[3])
                outcome[-1].append(res)
        for u, board, to_play, last, pi, z, z_valid, pi_valid in \
                (self.ring_rows or []):
            chunk = plies[u - 1]
            seq = outcome[u - 1] + outcome[u]
            t_plies, k = len(chunk), len(chunk[0][4])
            got = [x.cpu() for x in (board, to_play, last, z, z_valid,
                                     pi_valid)]
            got_pi = pi.cpu()
            for j in range(k):
                w, have = 0, False
                zs = [None] * t_plies
                for t in range(len(seq) - 1, -1, -1):
                    r = seq[t][j]
                    if r.done:
                        w, have = r.winner, True
                    if t < t_plies:
                        zs[t] = (w, have)
                for t in range(t_plies):
                    row = t * k + j
                    rec = chunk[t]
                    want_pi = torch.from_numpy(rec[5][j]).to(torch.bfloat16)
                    ok = (np.array_equal(got[0][row].numpy(), rec[0][j])
                          and int(got[1][row]) == int(rec[1][j])
                          and int(got[2][row]) == int(rec[2][j])
                          and int(got[3][row]) == zs[t][0] * int(rec[1][j])
                          and bool(got[4][row]) == zs[t][1]
                          and bool(got[5][row])
                          and torch.equal(got_pi[row], want_pi))
                    ring += not ok
                    self.judged["ring_rows"] += 1
        return played, ring

    def _judge_learner(self, weights, control: bool, out: Dict) -> Dict:
        """The learner's first steps: the reference builds each batch
        from the ring's rows and symmetries the benchmark handed the
        sampler (`batch_faults` counts rows where the program's batch
        differs, and batches of another size) and follows the steps on
        its own batches from the bundle's weights."""
        rec = self.learner
        train = {k: getattr(self.ctx.cfg.train, k) for k in
                 ("learning_rate", "lr_warmup_steps", "l2_coef",
                  "value_loss_weight")}
        bs = self.ctx.cfg.replay.batch_size
        faults = sum(r != bs for r in rec["rows"])
        batches = []
        for got, sample in zip(rec["batches"], rec["samples"]):
            if sample is None:   # a batch the benchmark did not draw
                faults += int(got[0].shape[0])
                continue
            want = ref_learner.batch_from_rows(
                self.ctx.arch, self.ctx.cfg.env.board_size, *sample)
            same = torch.ones(want[0].shape[0], dtype=torch.bool,
                              device=want[0].device)
            if all(g.shape == w.shape for g, w in zip(got, want)):
                for g, w in zip(got, want):
                    same &= (g.float() == w).reshape(w.shape[0], -1).all(-1)
                faults += int((~same).sum())
            else:
                faults += int(want[0].shape[0])
            batches.append(want)
        res = {"batch_faults": faults}
        if not batches:
            res.update(loss_gap=None, grad_gap=None, change_gap=None,
                       change_gap_median=None)
            return res
        dev = self.ctx.device
        arch = self.ctx.arch
        ref = ref_learner.run_steps(arch, weights[0], batches, train, dev)
        prog = {"losses": rec["losses"],
                "first_grad": {k: float(torch.linalg.vector_norm(m))
                               / (1 - ref_learner.ADAM_B1)
                               for k, m in rec["mu1"].items()},
                "change": {k: float(torch.linalg.vector_norm(
                    rec["pK"][k] - rec["p0"][k])) for k in rec["p0"]}}
        res.update(learner_gaps(prog, ref))
        res["learner_steps_checked"] = len(batches)
        if control:
            low = ref_learner.run_steps(arch, weights[0], batches, train,
                                        dev, quant=ref_net.fp8)
            out.setdefault("control", {}).update(learner_gaps(low, ref))
            half = ref_learner.run_steps(
                arch, weights[0], [[t[:t.shape[0] // 2] for t in b]
                             for b in batches], train, dev)
            out["fault_half_batch"] = learner_gaps(half, ref)
        return res


def learner_gaps(prog: Dict, ref: Dict) -> Dict:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    change_gap: the worst leaf's gap between the two norms of the first
    clipped gradient and of the weights' change, each over the larger of
    the reference's norm of that leaf and of the median leaf;
    change_gap_median: the median leaf's gap of the change, the one
    compared (a small leaf's change swings with its tiniest gradients,
    which Adam scales up to its epsilon). Leaves whose reference gradient
    is under a thousandth of the median leaf's are left out of the
    change: Adam moves them by round-off alone."""
    losses = [abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(prog["losses"], ref["losses"])]
    g_med = statistics.median(ref["first_grad"].values())
    grad = {k: abs(prog["first_grad"][k] - v) / max(v, g_med)
            for k, v in ref["first_grad"].items()}
    raw_med = statistics.median(ref["raw_grad"].values())
    kept = [k for k, v in ref["raw_grad"].items() if v >= 1e-3 * raw_med]
    c_med = statistics.median(ref["change"][k] for k in kept)
    change = {k: abs(prog["change"][k] - ref["change"][k])
              / max(ref["change"][k], c_med, 1e-30) for k in kept}
    worst = lambda d: max(d, key=d.get)
    return {"loss_gap": max(losses), "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "change_gap_median": statistics.median(change.values()),
            "grad_gap_leaf": worst(grad), "change_gap_leaf": worst(change),
            "leaves_left_out": sorted(set(ref["raw_grad"]) - set(kept))}
