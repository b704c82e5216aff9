/* keisei-tpu dashboard — pure helpers shared by app.js and the node:test
 * unit suite (lib.test.mjs). Everything here is DOM-free so it runs
 * identically in the browser and under `node --test` in CI (the analogue
 * of the reference webui's colocated vitest files per lib/*.js).
 *
 * Dual export: browser gets `window.KT`; node gets `module.exports`. */
"use strict";

(function (root, factory) {
  const api = factory();
  if (typeof module === "object" && module.exports) module.exports = api;
  else root.KT = api;
})(typeof self !== "undefined" ? self : this, function () {

  // -- shogi presentation ---------------------------------------------------
  const KANJI = { pawn: "歩", lance: "香", knight: "桂", silver: "銀",
                  gold: "金", bishop: "角", rook: "飛", king: "玉" };
  const KANJI_P = { pawn: "と", lance: "杏", knight: "圭", silver: "全",
                    bishop: "馬", rook: "龍" };
  const LETTER = { pawn: "P", lance: "L", knight: "N", silver: "S",
                   gold: "G", bishop: "B", rook: "R", king: "K" };

  /** Display character for a piece cell {type, promoted} under a notation
   *  preference ("kanji" | "letters"). */
  function pieceChar(c, notation) {
    if (notation === "kanji")
      return c.promoted ? (KANJI_P[c.type] || KANJI[c.type]) : KANJI[c.type];
    return (c.promoted ? "+" : "") + (LETTER[c.type] || "?");
  }

  /** USI square ("7f") -> row-major cell index (row 0 = rank a, col 0 =
   *  file 9), or -1 for malformed input. */
  function usiToCell(usi) {
    if (typeof usi !== "string" || usi.length < 2) return -1;
    const file = usi.charCodeAt(0) - 48, rank = usi.charCodeAt(1) - 97;
    if (file < 1 || file > 9 || rank < 0 || rank > 8) return -1;
    return rank * 9 + (9 - file);
  }

  /** Destination cell of a USI move string ("7g7f", "P*5e"), or -1. */
  function usiDestCell(usi) {
    return typeof usi === "string" && usi.length >= 4
      ? usiToCell(usi.slice(2, 4)) : -1;
  }

  // -- showcase move semantics ---------------------------------------------
  /** The side that PLAYED move row m: current_player is the side to move
   *  AFTER the move, i.e. the mover's opponent. */
  function moverOf(m) {
    return m.current_player === "black" ? "white" : "black";
  }

  /** Black-perspective win probability in [0,1] from a move row, or null.
   *  value_estimate is from the mover's perspective. */
  function blackProb(m) {
    if (m.value_estimate == null) return null;
    const v = moverOf(m) === "black" ? m.value_estimate : -m.value_estimate;
    return (v + 1) / 2;
  }

  /** Black-perspective win probability for a LIVE board snapshot, where
   *  value_estimate is from the side-to-move's (current_player's)
   *  perspective — unlike showcase move rows, where it is the mover's
   *  (see blackProb). Returns null when no estimate is present. */
  function stmBlackProb(g) {
    if (g.value_estimate == null) return null;
    const v = g.current_player === "black" ? g.value_estimate : -g.value_estimate;
    return (v + 1) / 2;
  }

  /** Status label for a live-game thumbnail (reference gameThumbnail.js
   *  getStatusText): the result text once the game is over, else the ply. */
  function gameStatus(g) {
    return g.is_over
      ? String(g.result || "").replaceAll("_", " ")
      : `ply ${g.ply}`;
  }

  /** Advantage marker for a live-game thumbnail (reference gameThumbnail.js
   *  getAdvantage): confident when |value| > 0.3. Compared in value space —
   *  converting to probability first ((v+1)/2) moves the boundary by one
   *  ulp, so |value| exactly 0.3 would wrongly read as confident. */
  function gameAdvantage(g) {
    if (g.value_estimate == null) return { confident: false, favours: null };
    const v = g.current_player === "black"
      ? g.value_estimate : -g.value_estimate;
    return { confident: Math.abs(v) > 0.3,
             favours: v > 0 ? "black" : "white" };
  }

  /** Filter freshly-pushed move rows against the already-held list.
   *  The server's init payload and poll task can race at connect time, so
   *  a move may arrive twice; plies are strictly increasing within a game. */
  function freshMoves(existing, incoming) {
    const seen = existing.length ? existing[existing.length - 1].ply : 0;
    return (incoming || []).filter((m) => m.ply > seen);
  }

  /** Parse a move_heatmap_json payload ({usi: prob}) into {cellIndex:
   *  alpha 0..1} normalized by the max prob. Returns null on bad input. */
  function heatCells(json) {
    let hm;
    try { hm = JSON.parse(json); } catch { return null; }
    if (!hm || typeof hm !== "object") return null;
    const vals = Object.values(hm).filter(Number.isFinite);
    if (!vals.length) return null;
    const mx = Math.max(...vals, 1e-9);
    const heat = {};
    for (const [usi, p] of Object.entries(hm)) {
      const cell = usiDestCell(usi);
      if (cell >= 0) heat[cell] = Math.max(heat[cell] || 0, p / mx);
    }
    return heat;
  }

  /** Per-move quality classification from the win-probability swing in the
   *  MOVER's perspective (reference MoveDots.svelte): "blunder" (lost >=25
   *  points), "mistake" (>=10), "strong" (gained >=10), "brilliant" (>=25),
   *  "normal" otherwise, null when either estimate is missing. */
  function moveDots(moves) {
    const out = [];
    let prev = null;
    for (const m of moves || []) {
      const p = blackProb(m);
      if (p == null || prev == null) {
        out.push(p == null ? null : "normal");
        prev = p;
        continue;
      }
      const delta = p - prev; // black-perspective swing across this move
      const gain = moverOf(m) === "black" ? delta : -delta;
      out.push(gain <= -0.25 ? "blunder" : gain <= -0.10 ? "mistake"
             : gain >= 0.25 ? "brilliant" : gain >= 0.10 ? "strong"
             : "normal");
      prev = p;
    }
    return out;
  }

  /** Aggregate match stats per side from showcase move rows (reference
   *  ShowcaseStatsBanner.svelte). Hodges strings carry the classifier:
   *  "x" = capture, "*" = drop, TRAILING "+" = promotion (a leading "+"
   *  is a promoted-piece prefix, not a promotion). `in_check` marks the
   *  mover's opponent in check after the move. */
  function showcaseStats(moves) {
    const mk = () => ({ captures: 0, drops: 0, promotions: 0, checks: 0 });
    const s = { black: mk(), white: mk(), plies: (moves || []).length };
    for (const m of moves || []) {
      const side = s[moverOf(m)];
      const n = m.usi_notation || "";
      if (n.includes("x")) side.captures += 1;
      if (n.includes("*")) side.drops += 1;
      if (n.endsWith("+")) side.promotions += 1;
      if (m.in_check) side.checks += 1;
    }
    return s;
  }

  /** Collapse consecutive league-event rows that say the same thing about
   *  the same entry into one row with a count (reference collapseEvents.js).
   *  Rows keep their first-seen order; each gets {..., count}. */
  function collapseEvents(transitions, max = 25) {
    const out = [];
    for (const t of transitions || []) {
      const label = `${t.from_role || ""}>${t.to_role || ""}|` +
                    `${t.from_status || ""}>${t.to_status || ""}`;
      const last = out[out.length - 1];
      if (last && last.entry_id === t.entry_id && last._label === label) {
        last.count += 1;
      } else {
        out.push({ ...t, count: 1, _label: label });
        if (out.length > max) break;
      }
    }
    return out.slice(0, max);
  }

  // -- league data shaping --------------------------------------------------
  /** Normalize head_to_head rows to entry `id`'s perspective:
   *  [{opp, w, l, d, g}] (reference EntryDetail.svelte semantics). */
  function h2hFor(rows, id) {
    const out = [];
    for (const r of rows || []) {
      if (r.entry_a_id === id)
        out.push({ opp: r.entry_b_id, w: r.wins_a, l: r.wins_b,
                   d: r.draws, g: r.games });
      else if (r.entry_b_id === id)
        out.push({ opp: r.entry_a_id, w: r.wins_b, l: r.wins_a,
                   d: r.draws, g: r.games });
    }
    return out;
  }

  /** Win rate (draws = half) of a normalized h2h record; null if no games. */
  function winRate(r) {
    return r.g ? (r.w + 0.5 * r.d) / r.g : null;
  }

  /** Training liveness badge (reference indicator.js getIndicator +
   *  StatusIndicator.svelte phase badges). alive comes from heartbeat
   *  freshness; status/phase from training_state. */
  function indicator(alive, status, phase) {
    if (alive) {
      if (phase === "update") return { cls: "update", text: "▲ PPO UPDATE" };
      if (phase === "rollout") return { cls: "rollout", text: "▶ ROLLOUT" };
      return { cls: "alive", text: "● ALIVE" };
    }
    if (status === "completed") return { cls: "stopped", text: "■ COMPLETED" };
    if (status === "paused") return { cls: "stopped", text: "■ PAUSED" };
    if (status === "stopped") return { cls: "stopped", text: "■ STOPPED" };
    return { cls: "stale", text: "◐ STALE — no heartbeat" };
  }

  /** true if an ISO-8601 UTC heartbeat is fresher than staleAfterS
   *  (server-side twin: app.py _heartbeat_alive, 30 s). */
  function heartbeatFresh(iso, nowMs, staleAfterS) {
    if (!iso || typeof iso !== "string") return false;
    const t = Date.parse(iso.endsWith("Z") || iso.includes("+") ? iso : iso + "Z");
    if (!Number.isFinite(t)) return false;
    return (nowMs - t) / 1000 < (staleAfterS == null ? 30 : staleAfterS);
  }

  /** Multi-line run-config summary for the model card's hover tooltip
   *  (reference configTooltip.js buildConfigTooltip). */
  function configSummary(configJson, modelArch) {
    const cfg = typeof configJson === "string"
      ? safeParse(configJson, null) : configJson;
    if (!cfg) return modelArch || "";
    const lines = [`Architecture: ${modelArch || cfg.model?.architecture || "?"}`];
    const t = cfg.training || {};
    if (t.algorithm) lines.push(`Algorithm: ${t.algorithm}`);
    if (t.num_games) lines.push(`Envs: ${t.num_games}`);
    if (t.steps_per_epoch) lines.push(`Steps/epoch: ${t.steps_per_epoch}`);
    if (t.max_ply) lines.push(`Max ply: ${t.max_ply}`);
    if (cfg.algorithm_params?.batch_size)
      lines.push(`Batch: ${cfg.algorithm_params.batch_size}`);
    if (cfg.league?.enabled) lines.push("League: on");
    return lines.join("\n");
  }

  /** |policy_loss / value_loss| per metrics row as [epoch, ratio] points.
   *  A stable ratio signals healthy co-training of the two heads
   *  (reference MetricsGrid pvRatio series, metricsColumns.js); null-safe
   *  on missing rows and guards value_loss == 0. */
  function pvRatio(rows) {
    return (rows || []).map((r) => {
      const p = r.policy_loss, v = r.value_loss;
      const ok = p != null && v != null && Number.isFinite(p) &&
                 Number.isFinite(v) && v !== 0;
      return [r.epoch || 0, ok ? Math.abs(p / v) : null];
    });
  }

  /** Stable-sorted copy of league entries for the table. key: "name" |
   *  "role" | "elo" | "games" | "style"; dir: 1 asc, -1 desc. styleOf
   *  maps entry id -> style label (used only for key "style"). Unknown
   *  keys fall back to Elo descending. */
  /** Per-entry W/L/D/games aggregates from league_results rows (each row
   *  is a multi-game match; both seats are credited). */
  function entryRecords(results) {
    const rec = {};
    const get = (id) => rec[id] || (rec[id] = { w: 0, l: 0, d: 0, g: 0 });
    for (const r of results || []) {
      const games = (r.wins_a || 0) + (r.wins_b || 0) + (r.draws || 0);
      const a = get(r.entry_a_id), b = get(r.entry_b_id);
      a.w += r.wins_a || 0; a.l += r.wins_b || 0; a.d += r.draws || 0;
      b.w += r.wins_b || 0; b.l += r.wins_a || 0; b.d += r.draws || 0;
      a.g += games; b.g += games;
    }
    return rec;
  }

  /** Latest Elo movement per entry: newest rating minus the one before it
   *  in that entry's history (0 with fewer than two points). Rows may
   *  arrive in any order. */
  function eloDeltas(eloHistory) {
    const hist = new Map();
    for (const r of eloHistory || []) {
      if (!hist.has(r.entry_id)) hist.set(r.entry_id, []);
      hist.get(r.entry_id).push([r.epoch, r.elo_rating]);
    }
    const out = {};
    for (const [id, pts] of hist) {
      pts.sort((a, b) => a[0] - b[0]);
      out[id] = pts.length < 2 ? 0 : pts[pts.length - 1][1] - pts[pts.length - 2][1];
    }
    return out;
  }

  /** Group entries into the tier order the reference table uses
   *  (frontier, recent, dynamic, historical, other), preserving the
   *  incoming (already sorted) order inside each group. */
  const TIER_ORDER = [
    ["frontier", (role) => role.startsWith("frontier")],
    ["recent", (role) => role.startsWith("recent")],
    ["dynamic", (role) => role.startsWith("dynamic")],
    ["historical", (role) => role.startsWith("historical")],
  ];
  function groupEntriesByTier(entries) {
    const groups = TIER_ORDER.map(([tier]) => ({ tier, items: [] }));
    const other = { tier: "other", items: [] };
    for (const e of entries || []) {
      const role = e.role || "";
      const g = groups.find((_, i) => TIER_ORDER[i][1](role));
      (g || other).items.push(e);
    }
    if (other.items.length) groups.push(other);
    return groups.filter((g) => g.items.length);
  }

  function sortEntries(entries, key, dir, styleOf, aux) {
    const records = (aux && aux.records) || {};
    const deltas = (aux && aux.deltas) || {};
    const val = (e) => {
      switch (key) {
        case "name": return (e.display_name || "entry " + e.id).toLowerCase();
        case "role": return e.role || "";
        case "games": return e.games_played || 0;
        case "style": return (styleOf && styleOf[e.id]) || "";
        case "elo": return e.elo_rating || 0;
        case "record": return (records[e.id] || { w: 0 }).w;
        case "wr": { const r = records[e.id]; const v = r && winRate(r); return v == null ? -1 : v; }
        case "delta": return deltas[e.id] || 0;
        default: return -(e.elo_rating || 0);
      }
    };
    const d = dir === 1 ? 1 : -1;
    return entries.map((e, i) => [e, i]).sort((a, b) => {
      const va = val(a[0]), vb = val(b[0]);
      if (va < vb) return -d;
      if (va > vb) return d;
      return a[1] - b[1];   // stable
    }).map(([e]) => e);
  }

  /** Role badge descriptor for a league entry (reference roleIcons.js,
   *  per tiered-opponent-pool spec §15.3: frontier=shield, recent=spark,
   *  dynamic=crossed swords, historical=scroll). Roles are matched by
   *  prefix because tier names carry suffixes ("frontier_static"). A
   *  retired entry shows the retired badge regardless of role. */
  const ROLE_INFO = [
    ["frontier", { icon: "🛡", label: "Frontier", cssClass: "role-frontier",
      tooltip: "Frontier — strongest fixed checkpoints, the bar to clear" }],
    ["recent", { icon: "✦", label: "Recent", cssClass: "role-recent",
      tooltip: "Recent — the last few snapshots of the training policy" }],
    ["dynamic", { icon: "⚔", label: "Dynamic", cssClass: "role-dynamic",
      tooltip: "Dynamic — evolving opponents that keep learning" }],
    ["historical", { icon: "📜", label: "Historical",
      cssClass: "role-historical",
      tooltip: "Historical — archived milestone policies" }],
  ];
  const ROLE_RETIRED = { icon: "⏸", label: "Retired",
    cssClass: "role-retired", tooltip: "Retired — out of the active pool" };
  const ROLE_UNKNOWN = { icon: "?", label: "Unknown",
    cssClass: "role-unknown", tooltip: "Unknown role" };

  function roleInfo(role, status) {
    if (status === "retired") return ROLE_RETIRED;
    const hit = ROLE_INFO.find(([p]) => (role || "").startsWith(p));
    return hit ? hit[1] : ROLE_UNKNOWN;
  }

  /** League-wide recent-matches feed (reference RecentMatches.svelte):
   *  newest-first render rows with both players resolved, the pair's
   *  total clash count across ALL results (not just the shown window),
   *  and winner-perspective fields — winner first (A on a draw), pre-match
   *  Elo, per-side Elo deltas, win percentage, and an upset flag when the
   *  winner started 100+ Elo below the loser. */
  function recentMatches(results, entries, max = 30) {
    const byId = new Map((entries || []).map((e) => [e.id, e]));
    const clash = new Map();
    for (const r of results || []) {
      const k = [r.entry_a_id, r.entry_b_id].sort((x, y) => x - y).join("-");
      clash.set(k, (clash.get(k) || 0) + 1);
    }
    const name = (id) => {
      const e = byId.get(id);
      return e ? (e.display_name || "entry " + id) : "#" + id;
    };
    return (results || [])
      .slice()
      .sort((a, b) => b.id - a.id)
      .slice(0, max)
      .map((r) => {
        const wa = r.wins_a, wb = r.wins_b, d = r.draws || 0;
        const draw = wa === wb;
        const aWon = wa > wb;
        const ea = byId.get(r.entry_a_id), eb = byId.get(r.entry_b_id);
        const preA = r.elo_before_a != null ? Math.round(r.elo_before_a) : null;
        const preB = r.elo_before_b != null ? Math.round(r.elo_before_b) : null;
        const dA = r.elo_after_a != null && r.elo_before_a != null
          ? Math.round(r.elo_after_a - r.elo_before_a) : 0;
        const dB = r.elo_after_b != null && r.elo_before_b != null
          ? Math.round(r.elo_after_b - r.elo_before_b) : 0;
        const first = aWon || draw;   // winner (or A on a draw) leads
        const w = first ? wa : wb, l = first ? wb : wa;
        const total = wa + wb + d;
        const winnerElo = first ? preA : preB;
        const loserElo = first ? preB : preA;
        return {
          rid: r.id, epoch: r.epoch, type: r.match_type || "",
          aId: r.entry_a_id, bId: r.entry_b_id,
          aName: name(r.entry_a_id), bName: name(r.entry_b_id),
          wa, wb, d,
          winner: aWon ? "a" : draw ? "draw" : "b",
          clashes: clash.get(
            [r.entry_a_id, r.entry_b_id].sort((x, y) => x - y).join("-")) || 0,
          draw,
          winnerId: first ? r.entry_a_id : r.entry_b_id,
          loserId: first ? r.entry_b_id : r.entry_a_id,
          winnerName: name(first ? r.entry_a_id : r.entry_b_id),
          loserName: name(first ? r.entry_b_id : r.entry_a_id),
          winnerRole: (first ? ea : eb) ? (first ? ea : eb).role : null,
          loserRole: (first ? eb : ea) ? (first ? eb : ea).role : null,
          winnerStatus: (first ? ea : eb) ? (first ? ea : eb).status : null,
          loserStatus: (first ? eb : ea) ? (first ? eb : ea).status : null,
          winnerElo, loserElo,
          eloWinner: first ? dA : dB,
          eloLoser: first ? dB : dA,
          w, l, total,
          winPct: total > 0 ? Math.round((w / total) * 100) : 0,
          upset: !draw && winnerElo != null && loserElo != null
            && loserElo - winnerElo >= 100,
        };
      });
  }

  /** Showcase scorecard (reference MatchScorecard.svelte): both players
   *  resolved from league entries (showcase entry ids are TEXT in the DB,
   *  so match by string coercion) plus a [0,1] game-progress fraction
   *  against an estimated typical game length. */
  function scorecard(game, entries, displayedPly, estTotalPly = 140) {
    if (!game) return null;
    const find = (id) =>
      (entries || []).find((e) => String(e.id) === String(id)) || null;
    const side = (id, fallbackName, fallbackElo) => {
      const e = find(id);
      return {
        id, name: (e && e.display_name) || fallbackName || "#" + id,
        elo: e != null && e.elo_rating != null ? e.elo_rating
          : fallbackElo != null ? fallbackElo : null,
        role: (e && e.role) || null,
        architecture: (e && e.architecture) || null,
      };
    };
    const ply = displayedPly != null ? displayedPly : game.total_ply || 0;
    return {
      black: side(game.entry_id_black, game.name_black, game.elo_black),
      white: side(game.entry_id_white, game.name_white, game.elo_white),
      progress: Math.max(0, Math.min(1, ply / Math.max(estTotalPly, 1))),
      status: game.status || "in_progress",
    };
  }

  // -- piece-movement legend (reference ShogiLegend + MoveDots) -------------
  // 3x3 grids from the mover's perspective (up = toward the opponent).
  // "step" = one square, "slide" = any distance, "jump" = knight leap
  // (over the adjacent square). Center cell is the piece itself.
  const S_ = "step", L_ = "slide", J_ = "jump";
  const GOLD_GRID = [[S_, S_, S_], [S_, null, S_], [null, S_, null]];
  const MOVE_PATTERNS = {
    pawn: [[null, S_, null], [null, null, null], [null, null, null]],
    lance: [[null, L_, null], [null, null, null], [null, null, null]],
    knight: [[J_, null, J_], [null, null, null], [null, null, null]],
    silver: [[S_, S_, S_], [null, null, null], [S_, null, S_]],
    gold: GOLD_GRID,
    bishop: [[L_, null, L_], [null, null, null], [L_, null, L_]],
    rook: [[null, L_, null], [L_, null, L_], [null, L_, null]],
    king: [[S_, S_, S_], [S_, null, S_], [S_, S_, S_]],
  };
  const PROMOTED_PATTERNS = {
    // promoted pawn/lance/knight/silver all move as gold
    pawn: GOLD_GRID, lance: GOLD_GRID, knight: GOLD_GRID, silver: GOLD_GRID,
    // horse: bishop slides + orthogonal steps; dragon: rook slides +
    // diagonal steps
    bishop: [[L_, S_, L_], [S_, null, S_], [L_, S_, L_]],
    rook: [[S_, L_, S_], [L_, null, L_], [S_, L_, S_]],
  };

  /** 3x3 movement grid for a piece kind ("pawn".."king"), or null for
   *  unknown kinds / unpromotable promotions (gold, king). */
  function movePattern(kind, promoted) {
    if (promoted) return PROMOTED_PATTERNS[kind] || null;
    return MOVE_PATTERNS[kind] || null;
  }

  // -- chart math -----------------------------------------------------------
  /** "Nice" tick positions covering [lo, hi] with about n intervals. */
  function niceTicks(lo, hi, n = 4) {
    if (!Number.isFinite(lo) || !Number.isFinite(hi)) return [];
    if (lo === hi) { lo -= 1; hi += 1; }
    const span = hi - lo;
    const step0 = span / Math.max(n, 1);
    const mag = Math.pow(10, Math.floor(Math.log10(step0)));
    const norm = step0 / mag;
    const step = (norm >= 5 ? 5 : norm >= 2 ? 2 : 1) * mag;
    const t0 = Math.ceil(lo / step) * step;
    const ticks = [];
    // epsilon guards float drift at the top edge
    for (let t = t0; t <= hi + step * 1e-9; t += step)
      ticks.push(Math.abs(t) < step * 1e-9 ? 0 : t);
    return ticks;
  }

  /** Exponential moving average over [x,y] points (non-finite y passed
   *  through untouched, EMA state unchanged). alpha in (0,1]: 1 = raw. */
  function ema(points, alpha) {
    if (!(alpha > 0) || alpha >= 1) return points;
    let acc = null;
    return points.map(([x, y]) => {
      if (!Number.isFinite(y)) return [x, y];
      acc = acc == null ? y : alpha * y + (1 - alpha) * acc;
      return [x, acc];
    });
  }

  /** Min-max bucket downsampling: keeps extremes so spikes survive.
   *  Returns points unchanged when already within budget. */
  function downsample(points, maxN) {
    if (points.length <= maxN || maxN < 4) return points;
    const buckets = Math.floor(maxN / 2);
    const per = points.length / buckets;
    const out = [];
    for (let b = 0; b < buckets; b++) {
      const s = Math.floor(b * per), e = Math.min(Math.floor((b + 1) * per),
                                                  points.length);
      let mn = null, mx = null;
      for (let i = s; i < e; i++) {
        const p = points[i];
        if (!Number.isFinite(p[1])) continue;
        if (!mn || p[1] < mn[1]) mn = p;
        if (!mx || p[1] > mx[1]) mx = p;
      }
      if (!mn) continue;
      // emit in x order to keep the polyline monotone in x
      if (mn === mx) out.push(mn);
      else if (mn[0] <= mx[0]) out.push(mn, mx);
      else out.push(mx, mn);
    }
    return out;
  }

  /** Index of the point whose x is nearest to `x` (for hover tooltips);
   *  -1 when the series is empty. Points must be sorted by x. */
  function nearestIndex(points, x) {
    if (!points.length) return -1;
    let lo = 0, hi = points.length - 1;
    while (hi - lo > 1) {
      const mid = (lo + hi) >> 1;
      if (points[mid][0] < x) lo = mid; else hi = mid;
    }
    return Math.abs(points[lo][0] - x) <= Math.abs(points[hi][0] - x) ? lo : hi;
  }

  /** "2d 4h", "3h 12m", "45s" — elapsed-time formatting for status cards
   *  (reference timeFormat.js). Negative/invalid input returns "—". */
  function timeFormat(seconds) {
    if (!Number.isFinite(seconds) || seconds < 0) return "—";
    const d = Math.floor(seconds / 86400);
    const h = Math.floor((seconds % 86400) / 3600);
    const m = Math.floor((seconds % 3600) / 60);
    const s = Math.floor(seconds % 60);
    if (d) return `${d}d ${h}h`;
    if (h) return `${h}h ${m}m`;
    if (m) return `${m}m ${s}s`;
    return `${s}s`;
  }

  /** JSON.parse that never throws (reference safeParse.js). */
  function safeParse(text, fallback = null) {
    if (typeof text !== "string" || !text) return fallback;
    try {
      const v = JSON.parse(text);
      return v == null ? fallback : v;
    } catch {
      return fallback;
    }
  }

  /** Plain-language explanations for the training charts, rendered as
   *  hover tooltips (reference configTooltip.js / AboutView glossary). */
  const METRIC_HELP = {
    "c-policy": "PPO clipped-surrogate policy loss. Hovers near zero by " +
      "construction; the trend matters less than entropy and win rates.",
    "c-value": "Cross-entropy of the win/draw/loss head against game " +
      "outcomes. Falling = the network predicts results better.",
    "c-entropy": "Policy uncertainty in nats (max ~9.3 over 11,259 " +
      "actions). Decays as the policy sharpens; a floor is scheduled.",
    "c-winrates": "Black/white win share of finished games. Black holds " +
      "a small first-move edge at equal strength.",
    "c-eplen": "Average game length in plies. Collapsing lengths can " +
      "signal degenerate play; max-ply truncations count as draws.",
    "c-gnorm": "Global gradient norm before clipping (clip at 1.0). " +
      "Spikes mean unusually surprising batches.",
    "c-wl": "Learner win and loss rates against the league cohort.",
    "c-pvratio": "|policy loss / value loss|. A stable ratio means the " +
      "two heads co-train healthily; sustained drift is an overfitting " +
      "warning (one head dominating the shared trunk).",
    "c-trunc": "Share of games hitting the max-ply ceiling.",
    "c-episodes": "Finished games per epoch across all parallel envs.",
    "c-elo": "League Elo over time, one line per pool entry.",
    "c-winprob": "The network's win probability for Black at each ply " +
      "of the showcase game.",
  };

  // -- about view (reference AboutView + stores/aboutLevel) ------------------
  // Five reading depths; each content section declares the minimum level at
  // which it appears, so sliding the level progressively reveals detail.
  const ABOUT_LEVELS = [
    { id: 1, label: "Glance", blurb: "one paragraph, no jargon" },
    { id: 2, label: "Curious", blurb: "how the learning loop works" },
    { id: 3, label: "Engineer", blurb: "inside the network and the data" },
    { id: 4, label: "Practitioner", blurb: "the algorithm and its knobs" },
    { id: 5, label: "Researcher", blurb: "framing, hardware mapping, limits" },
  ];

  /** Clamp an about level to the valid 1..N range (0/NaN -> 1). */
  function clampAboutLevel(n) {
    const max = ABOUT_LEVELS.length;
    if (!Number.isFinite(n)) return 1;
    return Math.min(max, Math.max(1, Math.round(n)));
  }

  /** TOC entries visible at `level` (those whose minLevel <= level). */
  function visibleAboutToc(items, level) {
    return items.filter((it) => it.minLevel <= level);
  }

  /** Group consecutive TOC items sharing a `section` heading, preserving
   *  order: [{section, items: [...]}]. Items with section=null each form
   *  their own headingless group. */
  function groupToc(items) {
    const groups = [];
    for (const it of items) {
      const last = groups[groups.length - 1];
      if (last && last.section === it.section && it.section != null)
        last.items.push(it);
      else groups.push({ section: it.section, items: [it] });
    }
    return groups;
  }

  /** Compact number formatting for axis labels / tooltips. */
  function fmt(v) {
    const a = Math.abs(v);
    if (a >= 1e6) return (v / 1e6).toFixed(1) + "M";
    if (a >= 1000) return (v / 1000).toFixed(1) + "k";
    if (a >= 10) return v.toFixed(1);
    if (a === 0) return "0";
    if (a < 0.001) return v.toExponential(1);
    return v.toPrecision(3);
  }

  return { pieceChar, usiToCell, usiDestCell, moverOf, blackProb,
           stmBlackProb, gameStatus, gameAdvantage,
           freshMoves, heatCells, moveDots, showcaseStats,
           collapseEvents, h2hFor, winRate, pvRatio,
           indicator, heartbeatFresh, configSummary,
           sortEntries, entryRecords, eloDeltas, groupEntriesByTier,
           roleInfo, recentMatches, scorecard, movePattern,
           niceTicks, ema, downsample, nearestIndex, fmt,
           timeFormat, safeParse, METRIC_HELP,
           ABOUT_LEVELS, clampAboutLevel, visibleAboutToc, groupToc,
           KANJI, KANJI_P, LETTER };
});
