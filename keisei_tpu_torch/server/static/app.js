/* keisei-tpu dashboard: vanilla JS client for the WS push protocol
 * (server/app.py). Views: training metrics (canvas charts), live boards,
 * league (table, Elo history, matchup matrix, entry detail), showcase
 * (board + heatmap overlay, win-prob graph, move review, commentary,
 * queue), about. Header tools: theme, notation, move sounds.
 *
 * Component parity with the reference Svelte SPA (webui/src/): Board,
 * PieceTray (hands), MoveLog (click-to-review), EvalBar, WinProbGraph,
 * MetricsChart/MetricsGrid, LeagueView (LeagueTable, EntryDetail,
 * MatchupMatrix, EloChart, event log), ShowcaseView (CommentaryPanel,
 * MatchControls, MatchQueue, heatmap overlay), AboutView (aboutLevel),
 * theme/audio/notation stores.
 *
 * Pure logic lives in lib.js (window.KT), unit-tested under node:test in
 * CI (lib.test.mjs); this file owns DOM, WS, and canvas drawing only. */
"use strict";

const { usiToCell, moverOf, blackProb, stmBlackProb, fmt } = KT;

// ---------------------------------------------------------------------------
// state
// ---------------------------------------------------------------------------
const S = {
  metrics: [],          // rows from metrics table (pruned to MAX_POINTS)
  games: new Map(),     // game_id -> snapshot
  training: null,
  league: { entries: [], results: [], transitions: [], eloHistory: [],
            styles: [], h2h: [] },
  showcase: { game: null, moves: [], queue: [], alive: false },
  reviewPly: null,      // null = follow live; else index into showcase.moves
  selectedEntry: null,  // league entry id for the detail panel
  selectedGame: null,   // live-boards game id shown on the main board
  leagueSort: { key: "elo", dir: -1 },
  leagueView: "flat",    // "flat" | "grouped" (by tier)
};
const MAX_POINTS = 10000;

// ---------------------------------------------------------------------------
// persisted UI prefs (theme / notation / sound) — reference stores/theme,
// stores/notation, stores/audio
// ---------------------------------------------------------------------------
const prefs = {
  get theme() { return localStorage.getItem("ktpu-theme") || "dark"; },
  set theme(v) { localStorage.setItem("ktpu-theme", v); },
  get notation() { return localStorage.getItem("ktpu-notation") || "kanji"; },
  set notation(v) { localStorage.setItem("ktpu-notation", v); },
  get sound() { return localStorage.getItem("ktpu-sound") === "on"; },
  set sound(v) { localStorage.setItem("ktpu-sound", v ? "on" : "off"); },
  get smooth() { return localStorage.getItem("ktpu-smooth") !== "off"; },
  set smooth(v) { localStorage.setItem("ktpu-smooth", v ? "on" : "off"); },
  get aboutLevel() { return localStorage.getItem("ktpu-about-level") || "1"; },
  set aboutLevel(v) { localStorage.setItem("ktpu-about-level", v); },
};
function applyTheme() {
  document.documentElement.dataset.theme = prefs.theme;
  document.getElementById("toggle-theme").textContent =
    prefs.theme === "dark" ? "☾" : "☀";
}
function applyNotationBtn() {
  document.getElementById("toggle-notation").textContent = prefs.notation;
}
function applySoundBtn() {
  document.getElementById("toggle-sound").textContent = prefs.sound ? "🔊" : "🔇";
}
function applySmoothBtn() {
  document.getElementById("toggle-smooth").classList.toggle("on", prefs.smooth);
}

// move click sound: tiny WebAudio blip, no assets needed
let audioCtx = null;
function moveSound() {
  if (!prefs.sound) return;
  try {
    audioCtx = audioCtx || new (window.AudioContext || window.webkitAudioContext)();
    const o = audioCtx.createOscillator(), g = audioCtx.createGain();
    o.type = "triangle"; o.frequency.value = 660;
    g.gain.setValueAtTime(0.08, audioCtx.currentTime);
    g.gain.exponentialRampToValueAtTime(1e-4, audioCtx.currentTime + 0.09);
    o.connect(g).connect(audioCtx.destination);
    o.start(); o.stop(audioCtx.currentTime + 0.1);
  } catch { /* audio unavailable */ }
}

// ---------------------------------------------------------------------------
// websocket with reconnect/backoff
// ---------------------------------------------------------------------------
let ws = null, backoff = 500;
function connect() {
  const proto = location.protocol === "https:" ? "wss" : "ws";
  ws = new WebSocket(`${proto}://${location.host}/ws`);
  ws.onopen = () => {
    backoff = 500;
    setConn(true);
  };
  ws.onclose = () => {
    setConn(false);
    setTimeout(connect, backoff);
    backoff = Math.min(backoff * 2, 10000);
  };
  ws.onmessage = (ev) => {
    let msg;
    try { msg = JSON.parse(ev.data); } catch { return; }
    dispatch(msg);
  };
}
function send(obj) { if (ws && ws.readyState === 1) ws.send(JSON.stringify(obj)); }
function setConn(on) {
  const el = document.getElementById("conn");
  el.textContent = on ? "live" : "disconnected";
  el.className = "badge " + (on ? "on" : "off");
}

function dispatch(msg) {
  switch (msg.type) {
    case "init":
      S.metrics = msg.metrics || [];
      S.games = new Map((msg.games || []).map(g => [g.game_id, g]));
      S.training = msg.training_state;
      S.league = {
        entries: msg.league_entries || [], results: msg.league_results || [],
        transitions: msg.transitions || [], eloHistory: msg.elo_history || [],
        styles: msg.style_profiles || [], h2h: msg.head_to_head || [],
        historical: msg.historical_library || [],
        gauntlet: msg.gauntlet_results || [],
        tournamentStats: msg.tournament_stats || null,
      };
      if (msg.showcase) {
        S.showcase.game = msg.showcase.game;
        S.showcase.moves = msg.showcase.moves || [];
        S.showcase.queue = msg.showcase.queue || [];
        S.showcase.alive = !!msg.showcase.sidecar_alive;
      }
      renderAll();
      break;
    case "metrics_update":
      S.metrics.push(...msg.rows);
      if (S.metrics.length > MAX_POINTS) S.metrics.splice(0, S.metrics.length - MAX_POINTS);
      renderCharts(); renderStatus();
      break;
    case "game_update":
      for (const g of msg.snapshots) S.games.set(g.game_id, g);
      renderBoards();
      break;
    case "training_status":
      S.training = Object.assign({}, S.training, msg,
        { current_epoch: msg.epoch, current_step: msg.step });
      renderStatus();
      break;
    case "league_update":
      S.league.entries = msg.entries; S.league.results = msg.results;
      S.league.transitions = msg.transitions; S.league.eloHistory = msg.elo_history;
      S.league.h2h = msg.head_to_head || S.league.h2h;
      if (msg.style_profiles) S.league.styles = msg.style_profiles;
      if (msg.historical_library) S.league.historical = msg.historical_library;
      if (msg.gauntlet_results) S.league.gauntlet = msg.gauntlet_results;
      if (msg.tournament_stats) S.league.tournamentStats = msg.tournament_stats;
      renderLeague(); fillShowcaseSelectors();
      break;
    case "showcase_status":
      S.showcase.queue = msg.queue || [];
      S.showcase.alive = !!msg.sidecar_alive;
      if (msg.active_game_id === null) S.showcase.game = null;
      renderShowcaseStatus(); renderQueue();
      break;
    case "showcase_update": {
      const isNewGame = msg.game && (!S.showcase.game ||
        msg.game.id !== S.showcase.game.id);
      S.showcase.game = msg.game;
      if (isNewGame) { S.showcase.moves = []; S.reviewPly = null; }
      const fresh = KT.freshMoves(S.showcase.moves, msg.new_moves);
      if (fresh.length) { S.showcase.moves.push(...fresh); moveSound(); }
      renderShowcase();
      break;
    }
    case "showcase_error":
      toast(msg.error || "showcase error", "err");
      break;
    case "showcase_match_queued":
      toast(`Match queued: #${msg.entry_id_1} vs #${msg.entry_id_2} (${msg.speed})`, "ok");
      break;
    case "showcase_speed_changed":
      toast(`Queue #${msg.queue_id} speed → ${msg.speed}`, "ok");
      break;
    case "showcase_match_cancelled":
      toast(`Queue #${msg.queue_id} cancelled`, "ok");
      break;
    case "ping":
      send({ type: "pong" });
      break;
  }
}

// ---------------------------------------------------------------------------
// toast notifications for command replies (the reference surfaces these in
// MatchControls; here a shared transient banner keeps the SPA dependency-free)
// ---------------------------------------------------------------------------
function toast(text, kind) {
  const host = document.getElementById("toasts");
  const el = document.createElement("div");
  el.className = `toast ${kind}`;
  el.textContent = text;
  host.appendChild(el);
  setTimeout(() => el.classList.add("gone"), 3600);
  setTimeout(() => el.remove(), 4100);
}

// ---------------------------------------------------------------------------
// canvas line charts: nice ticks, min-max downsampling, optional EMA
// smoothing (raw series kept as a ghost), hover crosshair + value tooltip —
// the uPlot feature set the reference gets from its dependency, dependency-
// free (reference webui/src/components/MetricsChart.svelte)
// ---------------------------------------------------------------------------
function css(name) {
  return getComputedStyle(document.documentElement).getPropertyValue(name).trim();
}
const chartState = new Map();   // canvasId -> geometry + data for hover redraw

function drawChart(canvasId, series, opts = {}) {
  const cv = document.getElementById(canvasId);
  if (!cv) return;
  const w = cv.clientWidth, h = cv.clientHeight;
  if (!w || !h) return;

  const smooth = opts.smooth && prefs.smooth;
  const budget = Math.max(Math.floor(w * 2), 200);
  const plotted = series.map(s => {
    const pts = KT.downsample(s.points, budget);
    return { ...s, raw: pts, points: smooth ? KT.ema(pts, 0.2) : pts };
  });

  const all = plotted.flatMap(s =>
    s.points.concat(smooth ? s.raw : []).map(p => p[1])).filter(Number.isFinite);
  if (!all.length) {
    chartState.delete(canvasId);
    const ctx = sizeCanvas(cv, w, h);
    ctx.fillStyle = "#555"; ctx.font = "10px system-ui";
    ctx.fillText("no data", w / 2 - 18, h / 2);
    return;
  }
  let lo = Math.min(...all), hi = Math.max(...all);
  if (opts.zero) lo = Math.min(lo, 0);
  if (opts.unit) { lo = Math.min(lo, opts.unit[0]); hi = Math.max(hi, opts.unit[1]); }
  if (lo === hi) { lo -= 1; hi += 1; }
  const xs = plotted.flatMap(s => s.points.map(p => p[0]));
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const st = { series: plotted, lo, hi, x0, x1, w, h, opts,
               pad: { l: 42, r: 6, t: 6, b: 16 } };
  chartState.set(canvasId, st);
  renderChartFrame(cv, st, null);
  if (!cv.dataset.hover) {
    cv.dataset.hover = "1";
    cv.addEventListener("mousemove", ev => hoverChart(cv, ev));
    cv.addEventListener("mouseleave", () => {
      const s = chartState.get(cv.id);
      if (s) renderChartFrame(cv, s, null);
    });
  }
}

function sizeCanvas(cv, w, h) {
  const dpr = window.devicePixelRatio || 1;
  cv.width = w * dpr; cv.height = h * dpr;
  const ctx = cv.getContext("2d");
  ctx.scale(dpr, dpr);
  ctx.clearRect(0, 0, w, h);
  return ctx;
}

function renderChartFrame(cv, st, hoverX) {
  const { series, lo, hi, x0, x1, w, h, opts, pad } = st;
  const ctx = sizeCanvas(cv, w, h);
  const X = x => pad.l + (x - x0) / Math.max(x1 - x0, 1) * (w - pad.l - pad.r);
  const Y = y => pad.t + (1 - (y - lo) / (hi - lo)) * (h - pad.t - pad.b);
  st.X = X; st.Y = Y;
  ctx.font = "10px system-ui";

  // y gridlines + labels at nice positions
  ctx.strokeStyle = css("--line"); ctx.fillStyle = css("--dim");
  for (const y of KT.niceTicks(lo, hi, 4)) {
    ctx.beginPath(); ctx.moveTo(pad.l, Y(y)); ctx.lineTo(w - pad.r, Y(y)); ctx.stroke();
    ctx.fillText(fmt(y), 2, Y(y) + 3);
  }
  // x ticks along the bottom edge
  for (const x of KT.niceTicks(x0, x1, Math.max(2, Math.floor(w / 90)))) {
    ctx.fillText(fmt(x), X(x) - 6, h - 4);
  }

  const drawLine = (pts, color, width, alpha) => {
    ctx.save();
    ctx.globalAlpha = alpha; ctx.strokeStyle = color; ctx.lineWidth = width;
    ctx.beginPath();
    let started = false;
    for (const [x, y] of pts) {
      if (!Number.isFinite(y)) { started = false; continue; }
      if (!started) { ctx.moveTo(X(x), Y(y)); started = true; }
      else ctx.lineTo(X(x), Y(y));
    }
    ctx.stroke(); ctx.restore();
  };
  for (const s of series) {
    if (s.points !== s.raw) drawLine(s.raw, s.color, 1, 0.25);  // raw ghost
    drawLine(s.points, s.color, 1.4, 1);
  }

  if (opts.marker != null) {
    ctx.strokeStyle = css("--accent"); ctx.lineWidth = 1;
    ctx.beginPath(); ctx.moveTo(X(opts.marker), pad.t);
    ctx.lineTo(X(opts.marker), h - pad.b); ctx.stroke();
  }
  if (series.length > 1) {
    let lx = pad.l + 4;
    for (const s of series) {
      ctx.fillStyle = s.color;
      ctx.fillText(s.label || "", lx, pad.t + 9);
      lx += ctx.measureText(s.label || "").width + 14;
    }
  }

  if (hoverX != null) drawCrosshair(ctx, st, hoverX);
}

function drawCrosshair(ctx, st, px) {
  const { series, x0, x1, w, h, pad, X, Y } = st;
  const dataX = x0 + (px - pad.l) / Math.max(w - pad.l - pad.r, 1) * (x1 - x0);
  // snap to the nearest point of the longest series; report every series
  const main = series.reduce((a, b) => (b.points.length > a.points.length ? b : a));
  const i = KT.nearestIndex(main.points, dataX);
  if (i < 0) return;
  const snapX = main.points[i][0];

  ctx.strokeStyle = css("--dim"); ctx.lineWidth = 0.7;
  ctx.setLineDash([3, 3]);
  ctx.beginPath(); ctx.moveTo(X(snapX), pad.t); ctx.lineTo(X(snapX), h - pad.b);
  ctx.stroke(); ctx.setLineDash([]);

  const rows = [];
  for (const s of series) {
    const j = KT.nearestIndex(s.points, snapX);
    if (j < 0) continue;
    const [x, y] = s.points[j];
    if (x !== snapX || !Number.isFinite(y)) continue;
    rows.push({ color: s.color, text: `${s.label ? s.label + " " : ""}${fmt(y)}` });
    ctx.fillStyle = s.color;
    ctx.beginPath(); ctx.arc(X(x), Y(y), 2.5, 0, Math.PI * 2); ctx.fill();
  }
  if (!rows.length) return;
  ctx.font = "10px system-ui";
  const head = `@ ${fmt(snapX)}`;
  const tw = Math.max(ctx.measureText(head).width,
    ...rows.map(r => ctx.measureText(r.text).width)) + 12;
  const th = 13 * (rows.length + 1) + 6;
  let bx = X(snapX) + 8;
  if (bx + tw > w - 2) bx = X(snapX) - tw - 8;
  const by = pad.t + 2;
  ctx.fillStyle = css("--panel") || "rgba(20,24,30,0.92)";
  ctx.strokeStyle = css("--line");
  ctx.beginPath(); ctx.roundRect(bx, by, tw, th, 4); ctx.fill(); ctx.stroke();
  ctx.fillStyle = css("--dim");
  ctx.fillText(head, bx + 6, by + 12);
  rows.forEach((r, k) => {
    ctx.fillStyle = r.color;
    ctx.fillText(r.text, bx + 6, by + 12 + 13 * (k + 1));
  });
}

function hoverChart(cv, ev) {
  const st = chartState.get(cv.id);
  if (!st) return;
  const rect = cv.getBoundingClientRect();
  renderChartFrame(cv, st, ev.clientX - rect.left);
}

// ---------------------------------------------------------------------------
// training view
// ---------------------------------------------------------------------------
function card(k, v) {
  return `<div class="card"><div class="k">${k}</div><div class="v">${v}</div></div>`;
}
function renderStatus() {
  const t = S.training || {};
  const sys = t.system_stats || {};
  const last = S.metrics[S.metrics.length - 1] || {};
  const row = document.getElementById("status-row");
  // liveness badge: heartbeat freshness computed client-side so staleness
  // shows even when the server stops pushing (reference StatusIndicator)
  const alive = KT.heartbeatFresh(t.heartbeat_at, Date.now());
  const ind = KT.indicator(alive, t.status, t.phase);
  row.innerHTML =
    `<div class="card phase-badge ${ind.cls}" id="train-indicator">` +
    `<div class="v">${ind.text}</div></div>` +
    `<div class="card" id="model-card"><div class="k">model</div>` +
    `<div class="v">${t.display_name || t.model_arch || "—"}</div></div>` +
    card("status", t.status || "—") +
    card("phase", t.phase || "—") +
    card("epoch", `${t.current_epoch ?? "—"}${t.total_epochs ? " / " + t.total_epochs : ""}`) +
    card("episodes", t.episodes ?? "—") +
    card("draw rate", last.draw_rate != null ? (last.draw_rate * 100).toFixed(1) + "%" : "—") +
    card("ep length", last.avg_episode_length != null ? last.avg_episode_length.toFixed(0) : "—") +
    card("uptime", uptimeOf(t)) +
    card("cpu", sys.cpu_percent != null ? sys.cpu_percent + "%" : "—") +
    card("ram", sys.ram_used_gb != null ? `${sys.ram_used_gb}/${sys.ram_total_gb} GB` : "—");
  // run-config tooltip on the model card (reference configTooltip); set as
  // a DOM property so no HTML escaping of the multi-line text is needed
  const mc = row.querySelector("#model-card");  // created just above
  if (mc) mc.title = KT.configSummary(t.config_json, t.model_arch);
}

// run age from training_state.started_at vs heartbeat_at (both ISO-8601;
// heartbeat freezes the clock when training stops — reference train clock)
function uptimeOf(t) {
  if (!t.started_at) return "—";
  const start = Date.parse(t.started_at);
  if (!Number.isFinite(start)) return "—";
  const hb = t.heartbeat_at ? Date.parse(t.heartbeat_at) : NaN;
  const end = Number.isFinite(hb) ? hb : Date.now();
  return KT.timeFormat((end - start) / 1000);
}

// staleness develops without any WS traffic: refresh the badge on a timer
setInterval(() => {
  if (S.training) renderStatus();
}, 5000);

// hover explanations on every chart title (reference configTooltip)
function applyMetricHelp() {
  for (const [id, help] of Object.entries(KT.METRIC_HELP)) {
    const cv = document.getElementById(id);
    if (!cv) continue;
    const h3 = cv.closest(".chart-box")?.querySelector("h3");
    if (h3) h3.title = help;
  }
}
applyMetricHelp();
function seriesOf(field, color, label) {
  return { color, label, points: S.metrics.map(m => [m.epoch, m[field]]) };
}
function renderCharts() {
  drawChart("c-policy", [seriesOf("policy_loss", "#5aa9e6")], { smooth: true });
  drawChart("c-value", [seriesOf("value_loss", "#e6a95a")], { smooth: true });
  drawChart("c-pvratio",
    [{ color: "#5ae6c8", points: KT.pvRatio(S.metrics) }], { smooth: true });
  drawChart("c-entropy", [seriesOf("entropy", "#b98ae6")], { smooth: true });
  drawChart("c-winrates", [
    seriesOf("black_win_rate", "#63c57f", "black"),
    seriesOf("white_win_rate", "#e06c75", "white"),
    seriesOf("draw_rate", "#8b96a5", "draw"),
  ], { zero: true });
  drawChart("c-eplen", [seriesOf("avg_episode_length", "#5ae6c8")], { zero: true });
  drawChart("c-gnorm", [seriesOf("gradient_norm", "#e65a8f")], { smooth: true });
  drawChart("c-wl", [
    seriesOf("win_rate", "#63c57f", "win"),
    seriesOf("loss_rate", "#e06c75", "loss"),
  ], { zero: true });
  drawChart("c-trunc", [seriesOf("truncation_rate", "#e6a95a")], { zero: true });
  drawChart("c-episodes", [seriesOf("episodes_completed", "#5aa9e6")], { zero: true });
}

// ---------------------------------------------------------------------------
// shogi board rendering (snapshot board_json = 81 cells of null | piece dict)
// ---------------------------------------------------------------------------
function pieceChar(c) { return KT.pieceChar(c, prefs.notation); }
// heat: optional {cellIndex: alpha 0..1}; lastCell: optional index to outline
function boardHTML(board, heat = null, lastCell = -1) {
  let html = '<div class="grid">';
  for (let i = 0; i < 81; i++) {
    const c = board[i];
    const a = heat ? heat[i] : undefined;
    const overlay = a != null
      ? `<span class="heat" style="background:rgba(${css("--heat")},${(0.15 + 0.6 * a).toFixed(2)})"></span>`
      : "";
    const lm = i === lastCell ? " lastmove" : "";
    if (!c) { html += `<div class="sq${lm}">${overlay}</div>`; continue; }
    const cls = "sq" + (c.color === "white" ? " w" : "") + lm;
    html += `<div class="${cls}"><span class="p${c.promoted ? " promoted" : ""}">` +
            `${pieceChar(c)}</span>${overlay}</div>`;
  }
  return html + "</div>";
}
// board coordinate labels (reference Board.svelte coords): files 9→1
// across the top, ranks down the right in the active notation
function coordWrap(gridHTML) {
  const files = [];
  for (let f = 9; f >= 1; f--) files.push(`<span>${f}</span>`);
  const RANKS = prefs.notation === "kanji"
    ? ["一", "二", "三", "四", "五", "六", "七", "八", "九"]
    : ["a", "b", "c", "d", "e", "f", "g", "h", "i"];
  const ranks = RANKS.map(r => `<span>${r}</span>`).join("");
  return `<div class="board-wrap"><div class="files">${files.join("")}</div>` +
         `${gridHTML}<div class="ranks">${ranks}</div></div>`;
}

// tiny black-win-probability strip under a live board (black share filled)
function evalStripHTML(p) {
  if (p == null) return "";
  const pct = Math.round(p * 100);
  return `<div class="evalstrip" title="black ${pct}%">` +
         `<span style="width:${pct}%"></span></div>`;
}

function handsHTML(hands) {
  const pc = (k) => prefs.notation === "kanji" ? KT.KANJI[k] : KT.LETTER[k];
  const fmtSide = (h) => Object.entries(h || {})
    .filter(([, n]) => n > 0).map(([k, n]) => `${pc(k)}×${n}`).join(" ");
  return `<div class="hands">☗ ${fmtSide(hands.black)} &nbsp; ☖ ${fmtSide(hands.white)}</div>`;
}
// thumbnail strip + selected main board (reference App.svelte training
// layout: GameThumbnail per live game, one full Board for the selection)
function renderBoards() {
  if (!views.boards.classList.contains("active")) return;
  const count = parseInt(document.getElementById("boards-count").value, 10) || 24;
  const games = [...S.games.values()].sort((a, b) => a.game_id - b.game_id).slice(0, count);
  if (games.length && !games.some(g => g.game_id === S.selectedGame))
    S.selectedGame = games[0].game_id;

  const thumbs = document.getElementById("board-thumbs");
  thumbs.innerHTML = games.map(g => {
    const adv = KT.gameAdvantage(g);
    const dot = adv.confident
      ? `<span class="adv-dot ${adv.favours}" title="${adv.favours} advantage"></span>`
      : "";
    return `<button class="thumb${g.game_id === S.selectedGame ? " selected" : ""}"
      data-game="${g.game_id}" aria-pressed="${g.game_id === S.selectedGame}">
      ${boardHTML(KT.safeParse(g.board_json, []))}
      <span class="label">${dot}G${g.game_id} — ${KT.gameStatus(g)}</span></button>`;
  }).join("") || '<p style="color:var(--dim)">no live games yet</p>';
  for (const b of thumbs.querySelectorAll(".thumb")) {
    b.onclick = () => { S.selectedGame = parseInt(b.dataset.game, 10); renderBoards(); };
  }

  const main = document.getElementById("board-main");
  const g = games.find(x => x.game_id === S.selectedGame);
  if (!g) { main.innerHTML = ""; return; }
  main.innerHTML = `<div class="board-card">
    <div class="meta">game ${g.game_id} · ply ${g.ply} · ${g.current_player} to move
      ${g.in_check ? "· <b>check</b>" : ""} ${g.game_type === "demo" ? "· demo" : ""}
      ${g.is_over ? `· <b>${KT.gameStatus(g)}</b>` : ""}</div>
    ${coordWrap(boardHTML(KT.safeParse(g.board_json, [])))}
    ${evalStripHTML(stmBlackProb(g))}${handsHTML(KT.safeParse(g.hands_json, {}))}</div>`;
}

// ---------------------------------------------------------------------------
// league view
// ---------------------------------------------------------------------------
const ELO_COLORS = ["#5aa9e6", "#63c57f", "#e6a95a", "#e06c75", "#b98ae6",
                    "#5ae6c8", "#e65a8f", "#a9e65a", "#8b96a5", "#e6e65a"];
function renderLeague() {
  const tbody = document.querySelector("#league-table tbody");
  const learnerId = S.training && S.training.learner_entry_id;
  const styleOf = Object.fromEntries(S.league.styles.map(s => [s.checkpoint_id, s.primary_style]));
  const records = KT.entryRecords(S.league.results);
  const deltas = KT.eloDeltas(S.league.eloHistory);
  const { key: sortKey, dir: sortDir } = S.leagueSort;
  for (const th of document.querySelectorAll("#league-table thead th")) {
    if (!th.dataset.key) continue;
    th.classList.toggle("sorted", th.dataset.key === sortKey);
    th.dataset.dir = th.dataset.key === sortKey ? (sortDir === 1 ? "▲" : "▼") : "";
    if (!th.onclick) th.onclick = () => {
      const k = th.dataset.key;
      S.leagueSort = S.leagueSort.key === k
        ? { key: k, dir: -S.leagueSort.dir }
        : { key: k, dir: k === "name" || k === "role" ? 1 : -1 };
      renderLeague();
    };
  }
  // flat/grouped view toggle (reference LeagueTable viewMode radiogroup)
  const seg = document.getElementById("league-viewmode");
  if (seg && !seg.childElementCount) {
    seg.innerHTML = ["flat", "grouped"].map(m =>
      `<button data-mode="${m}">${m}</button>`).join("");
    for (const b of seg.querySelectorAll("button"))
      b.onclick = () => { S.leagueView = b.dataset.mode; renderLeague(); };
  }
  const mode = S.leagueView || "flat";
  if (seg) for (const b of seg.querySelectorAll("button"))
    b.classList.toggle("active", b.dataset.mode === mode);

  const sorted = KT.sortEntries(S.league.entries, sortKey, sortDir, styleOf,
                                { records, deltas });
  const rowHTML = (e, rank) => {
    const r = records[e.id];
    const wr = r ? KT.winRate(r) : null;
    const dlt = deltas[e.id] || 0;
    return `<tr data-entry="${e.id}" class="${e.id === learnerId ? "learner" : ""}${e.id === S.selectedEntry ? " selected" : ""}">
      <td class="num">${rank}</td>
      <td>${e.display_name || "entry " + e.id}${e.id === learnerId ? " ◀" : ""}</td>
      <td>${roleBadge(e.role, e.status)}${(e.role || "").replace("_static", "").replace("_fixed", "")}</td>
      <td>${Math.round(e.elo_rating)}</td>
      <td class="${dlt > 0.5 ? "up" : dlt < -0.5 ? "down" : ""}">${
        dlt ? (dlt > 0 ? "+" : "") + Math.round(dlt) : ""}</td>
      <td>${r ? `${r.w}-${r.l}-${r.d}` : ""}</td>
      <td>${wr != null ? `<span class="wr-bar"><span style="width:${Math.round(wr * 100)}%"></span></span>${Math.round(wr * 100)}%` : ""}</td>
      <td>${e.games_played}</td>
      <td>${styleOf[e.id] || ""}</td></tr>`;
  };
  if (mode === "grouped") {
    const groups = KT.groupEntriesByTier(sorted);
    tbody.innerHTML = groups.map(g =>
      `<tr class="tier-head"><td colspan="9">${g.tier} · ${g.items.length}</td></tr>` +
      g.items.map((e, i) => rowHTML(e, i + 1)).join("")).join("");
  } else {
    tbody.innerHTML = sorted.map((e, i) => rowHTML(e, i + 1)).join("");
  }
  for (const tr of tbody.querySelectorAll("tr[data-entry]")) {
    tr.onclick = () => {
      const id = parseInt(tr.dataset.entry, 10);
      S.selectedEntry = S.selectedEntry === id ? null : id;
      renderLeague();
    };
  }
  renderEntryDetail();
  renderMatchupMatrix();

  // elo history: one series per entry
  const byEntry = new Map();
  for (const r of S.league.eloHistory) {
    if (!byEntry.has(r.entry_id)) byEntry.set(r.entry_id, []);
    byEntry.get(r.entry_id).push([r.epoch, r.elo_rating]);
  }
  const names = Object.fromEntries(S.league.entries.map(e => [e.id, e.display_name]));
  const series = [...byEntry.entries()].slice(0, 10).map(([id, pts], i) => ({
    color: ELO_COLORS[i % ELO_COLORS.length],
    label: (names[id] || "#" + id).split(" ")[0],
    points: pts,
  }));
  drawChart("c-elo", series);

  document.getElementById("league-events").innerHTML =
    KT.collapseEvents(S.league.transitions, 25).map(t =>
      `<li>#${t.entry_id} ${t.from_role || ""}${t.to_role ? "→" + t.to_role : ""} ` +
      `${t.from_status ? t.from_status + "→" + t.to_status : ""} — ${t.reason || ""}` +
      `${t.count > 1 ? ` <span class="evt-count">×${t.count}</span>` : ""}</li>`
    ).join("");
  renderTournamentPanel();
  renderRecentMatches();
}

// role badge (reference roleIcons.js): tier icon + tooltip, retired-aware
function roleBadge(role, status) {
  const info = KT.roleInfo(role, status);
  return `<span class="role-icon ${info.cssClass}" title="${info.tooltip}"` +
    ` aria-label="${info.label}">${info.icon}</span>`;
}

function renderRecentMatches() {
  // reference RecentMatches.svelte: winner-first rows under epoch
  // separators, with role badges, pre-match Elo, per-side Elo deltas,
  // win %, an upset badge, and the pair's total clash count
  const el = document.getElementById("recent-matches");
  if (!el) return;
  const rows = KT.recentMatches(S.league.results, S.league.entries, 30);
  const out = [];
  let lastEpoch = null;
  for (const r of rows) {
    if (r.epoch !== lastEpoch) {
      out.push(`<li class="epoch-sep">epoch ${r.epoch}</li>`);
      lastEpoch = r.epoch;
    }
    const delta = (v) => v === 0 ? "" :
      `<span class="elo-delta ${v > 0 ? "pos" : "neg"}">` +
      `${v > 0 ? "+" : ""}${v}</span>`;
    const elo = (v) => v == null ? "" : `<span class="hint">(${v})</span>`;
    out.push(
      `<li class="${r.draw ? "" : r.winner === "a" ? "win" : "loss"}">` +
      `<div class="match-top">` +
      `<b>${roleBadge(r.winnerRole, r.winnerStatus)}${r.winnerName}</b>` +
      `${elo(r.winnerElo)} <span class="hint">vs</span> ` +
      `${roleBadge(r.loserRole, r.loserStatus)}${r.loserName}` +
      `${elo(r.loserElo)}` +
      (r.upset ? ' <span class="upset-badge" title="Upset: winner started ' +
        '100+ Elo below">!</span>' : "") +
      ` <span class="match-score${r.draw ? " tied" : ""}">` +
      `${r.w}-${r.l}${r.d ? "-" + r.d : ""}</span></div>` +
      `<div class="match-detail hint">${r.type || "match"}` +
      ` · ${r.winPct}%` +
      (r.eloWinner || r.eloLoser
        ? ` · ${delta(r.eloWinner)} / ${delta(r.eloLoser)}` : "") +
      (r.clashes > 1 ? ` · ×${r.clashes} lifetime` : "") +
      `</div></li>`);
  }
  el.innerHTML = out.join("") ||
    '<li style="border:none;color:var(--dim)">no matches yet</li>';
}

function renderTournamentPanel() {
  // tournament round stats + historical milestone slots + latest gauntlet
  // results (reference LeagueView side panels)
  const el = document.getElementById("tournament-panel");
  if (!el) return;
  const ts = S.league.tournamentStats;
  const names = Object.fromEntries(
    S.league.entries.map(e => [e.id, e.display_name || "#" + e.id]));
  let html = "";
  if (ts) {
    html += `<div class="kv">
      <span class="k">last round</span><span>${(ts.round_duration_s ?? 0).toFixed(1)} s,
        ${ts.pairings_completed ?? 0}/${ts.pairings_requested ?? 0} pairings,
        ${ts.total_games ?? 0} games (${Math.round(ts.games_per_min ?? 0)}/min)</span>
      <span class="k">model loads</span><span>${ts.model_load_count ?? 0}
        (${(ts.model_load_time_s ?? 0).toFixed(1)} s)</span>
    </div>`;
  }
  const hist = S.league.historical || [];
  if (hist.length) {
    // most recent gauntlet result per milestone slot
    const lastBySlot = new Map();
    for (const g of S.league.gauntlet || []) {
      const prev = lastBySlot.get(g.historical_slot);
      if (!prev || g.epoch >= prev.epoch) lastBySlot.set(g.historical_slot, g);
    }
    html += '<table class="matrix"><tr><th>slot</th><th>epoch</th>' +
      '<th>entry</th><th>last gauntlet (W-L-D)</th></tr>' +
      hist.map(h => {
        const g = lastBySlot.get(h.slot_index);
        return `<tr><td>${h.slot_index}</td>` +
          `<td>${h.actual_epoch ?? h.target_epoch}</td>` +
          `<td>${h.entry_name || names[h.entry_id] || "#" + h.entry_id}</td>` +
          `<td>${g ? `${g.wins}-${g.losses}-${g.draws} (ep ${g.epoch})` : "·"}</td></tr>`;
      }).join("") + "</table>";
  }
  el.innerHTML = html ||
    '<p style="color:var(--dim);font-size:12px">no tournament rounds yet</p>';
}

function h2hFor(id) { return KT.h2hFor(S.league.h2h, id); }

function styleCommentary(row) {
  try {
    const c = KT.safeParse(row.commentary_json, []);
    return Array.isArray(c) ? c.join(" ") : String(c);
  } catch { return ""; }
}

function renderEntryDetail() {
  const panel = document.getElementById("entry-detail");
  const e = S.league.entries.find(x => x.id === S.selectedEntry);
  if (!e) { panel.classList.add("hidden"); return; }
  panel.classList.remove("hidden");
  const styleRow = S.league.styles.find(s => s.checkpoint_id === e.id);
  let flavour = [];
  flavour = KT.safeParse(e.flavour_facts, []);
  const names = Object.fromEntries(S.league.entries.map(x => [x.id, x.display_name || "#" + x.id]));
  const h2h = h2hFor(e.id).sort((a, b) => b.g - a.g).slice(0, 6)
    .map(r => `${names[r.opp] || "#" + r.opp}: ${r.w}-${r.l}-${r.d}`).join(" · ");
  const kv = (k, v) => `<span class="k">${k}</span><span>${v ?? "—"}</span>`;
  panel.innerHTML = `<h4>${e.display_name || "entry " + e.id}</h4>
    <div class="kv">
      ${kv("role", e.role)} ${kv("status", e.status)}
      ${kv("elo (composite)", Math.round(e.elo_rating))}
      ${kv("elo frontier / dynamic / recent / hist",
           `${Math.round(e.elo_frontier)} / ${Math.round(e.elo_dynamic)} / ` +
           `${Math.round(e.elo_recent)} / ${Math.round(e.elo_historical)}`)}
      ${kv("games", `${e.games_played} (F${e.games_vs_frontier} D${e.games_vs_dynamic} R${e.games_vs_recent})`)}
      ${kv("created epoch", e.created_epoch)} ${kv("architecture", e.architecture)}
      ${kv("parent", e.parent_entry_id != null ? names[e.parent_entry_id] || "#" + e.parent_entry_id : "—")}
      ${kv("lineage", e.lineage_group)} ${kv("protection", e.protection_remaining)}
      ${kv("dynamic updates", e.update_count)}
      ${styleRow ? kv("style", `${styleRow.primary_style || ""} — ${styleCommentary(styleRow)}`) : ""}
      ${h2h ? kv("head-to-head", h2h) : ""}
    </div>
    ${flavour.length ? `<div class="flavour">${flavour.join(" · ")}</div>` : ""}
    <div class="chart-box"><h4>Elo trajectory</h4><canvas id="c-entry-elo"></canvas></div>
    <h4>Recent matches</h4><ul class="entry-results">${recentResultsHTML(e.id, names)}</ul>`;
  drawEntryEloChart(e.id);
}

// last matches involving the entry, newest first, from the entry's
// perspective (reference EntryDetail.svelte match list)
function recentResultsHTML(id, names) {
  const rows = [];
  for (const r of S.league.results) {
    if (r.entry_a_id !== id && r.entry_b_id !== id) continue;
    const mine = r.entry_a_id === id;
    const opp = mine ? r.entry_b_id : r.entry_a_id;
    const [w, l] = mine ? [r.wins_a, r.wins_b] : [r.wins_b, r.wins_a];
    const after = mine ? r.elo_after_a : r.elo_after_b;
    const before = mine ? r.elo_before_a : r.elo_before_b;
    const delta = after != null && before != null ? after - before : null;
    rows.push({ epoch: r.epoch, opp, w, l, d: r.draws,
                type: r.match_type, delta, rid: r.id });
  }
  rows.sort((a, b) => b.rid - a.rid);
  return rows.slice(0, 8).map(r => {
    const cls = r.w > r.l ? "win" : r.w < r.l ? "loss" : "";
    const dElo = r.delta != null
      ? ` <span class="delta">${r.delta >= 0 ? "+" : ""}${r.delta.toFixed(1)}</span>` : "";
    return `<li class="${cls}">ep ${r.epoch} · vs ${names[r.opp] || "#" + r.opp}
      · <b>${r.w}-${r.l}-${r.d}</b> · ${r.type || ""}${dElo}</li>`;
  }).join("") || '<li style="border:none;color:var(--dim)">no matches yet</li>';
}

function drawEntryEloChart(id) {
  // composite Elo from the history table, plus the per-match post-Elo
  // trail from league_results (elo_history only records the composite —
  // schema parity with the reference)
  const hist = S.league.eloHistory.filter(r => r.entry_id === id)
    .map(r => [r.epoch, r.elo_rating]);
  const after = [];
  for (const r of S.league.results) {
    if (r.entry_a_id === id && r.elo_after_a != null)
      after.push([r.epoch, r.elo_after_a]);
    else if (r.entry_b_id === id && r.elo_after_b != null)
      after.push([r.epoch, r.elo_after_b]);
  }
  after.sort((a, b) => a[0] - b[0]);
  const series = [];
  if (hist.length) series.push({ color: "#5aa9e6", label: "epoch", points: hist });
  if (after.length) series.push({ color: "#e6a95a", label: "post-match", points: after });
  drawChart("c-entry-elo", series);
}

function renderMatchupMatrix() {
  const el = document.getElementById("matchup-matrix");
  const entries = S.league.entries.slice(0, 12);
  if (entries.length < 2 || !S.league.h2h.length) {
    el.innerHTML = '<p style="color:var(--dim);font-size:12px">no matches yet</p>';
    return;
  }
  const key = (a, b) => `${a},${b}`;
  const map = new Map();
  for (const r of S.league.h2h) {
    map.set(key(r.entry_a_id, r.entry_b_id), { w: r.wins_a, l: r.wins_b, d: r.draws, g: r.games });
    map.set(key(r.entry_b_id, r.entry_a_id), { w: r.wins_b, l: r.wins_a, d: r.draws, g: r.games });
  }
  const short = e => (e.display_name || "#" + e.id).split(" ")[0];
  // diverging two-hue scale around the 50% midpoint (never a hue sweep):
  // losing cells step into --bad, winning into --good, alpha ∝ |wr - 0.5|
  const cellBg = (wr) => {
    const a = Math.min(0.55, Math.abs(wr - 0.5) * 1.3 + 0.08);
    return wr >= 0.5
      ? `color-mix(in srgb, var(--good) ${Math.round(a * 100)}%, transparent)`
      : `color-mix(in srgb, var(--bad) ${Math.round(a * 100)}%, transparent)`;
  };
  let html = '<table class="matrix" id="mm-table"><tr><th></th>' +
    entries.map((e, j) => `<th data-col="${j}" title="${e.display_name || e.id}">${short(e)}</th>`).join("") + "</tr>";
  entries.forEach((a, i) => {
    html += `<tr><th data-row="${i}" title="${a.display_name || a.id}">${short(a)}</th>`;
    entries.forEach((b, j) => {
      if (a.id === b.id) { html += `<td data-row="${i}" data-col="${j}" style="background:var(--line)"></td>`; return; }
      const r = map.get(key(a.id, b.id));
      if (!r || !r.g) { html += `<td data-row="${i}" data-col="${j}">·</td>`; return; }
      const wr = (r.w + 0.5 * r.d) / r.g;
      html += `<td data-row="${i}" data-col="${j}" style="background:${cellBg(wr)}" ` +
        `title="${short(a)} vs ${short(b)}: ${r.w}-${r.l}-${r.d} (${r.g} games)">` +
        `${Math.round(wr * 100)}</td>`;
    });
    html += "</tr>";
  });
  html += "</table>";
  // legend: two hues + neutral midpoint, never color-alone (cells carry
  // the numeric win % and a full tooltip)
  html += '<div class="matrix-legend" aria-label="color legend">' +
    `<span class="legend-swatch" style="background:${cellBg(0)}"></span>0%` +
    '<span class="legend-swatch" style="background:transparent;border:1px solid var(--line)"></span>50%' +
    `<span class="legend-swatch" style="background:${cellBg(1)}"></span>100%` +
    '<span class="hint">row player’s score vs column player</span></div>';
  el.innerHTML = html;
  // hover crosshair: highlight the full row + column under the pointer
  const table = el.querySelector("#mm-table");
  table.addEventListener("mouseover", (ev) => {
    const t = ev.target.closest("[data-row],[data-col]");
    const row = t ? t.dataset.row : null, col = t ? t.dataset.col : null;
    for (const c of table.querySelectorAll("td,th")) {
      c.classList.toggle("mm-hl",
        (row != null && c.dataset.row === row) ||
        (col != null && c.dataset.col === col));
    }
  });
  table.addEventListener("mouseleave", () => {
    for (const c of table.querySelectorAll(".mm-hl")) c.classList.remove("mm-hl");
  });
}

// ---------------------------------------------------------------------------
// showcase view
// ---------------------------------------------------------------------------
function fillShowcaseSelectors() {
  for (const id of ["sc-e1", "sc-e2"]) {
    const sel = document.getElementById(id);
    const cur = sel.value;
    sel.innerHTML = S.league.entries.map(e =>
      `<option value="${e.id}">${e.display_name || "entry " + e.id} (${Math.round(e.elo_rating)})</option>`
    ).join("");
    if (cur) sel.value = cur;
  }
}
function renderShowcaseStatus() {
  const el = document.getElementById("sc-status");
  const g = S.showcase.game;
  el.innerHTML =
    card("sidecar", S.showcase.alive ? "alive" : "offline") +
    card("queue", S.showcase.queue.length) +
    (g ? card("match", `${g.name_black || g.entry_id_black} vs ${g.name_white || g.entry_id_white}`) : "") +
    (g && g.result ? card("result", g.result) : "");
}
function renderQueue() {
  document.getElementById("sc-queue").innerHTML =
    S.showcase.queue.map(q =>
      `<li>#${q.id} ${q.entry_id_1} vs ${q.entry_id_2} · ${q.speed} · ${q.status}</li>`
    ).join("") || '<li style="border:none">empty</li>';
}
function displayedMove() {
  const moves = S.showcase.moves;
  if (!moves.length) return null;
  const i = S.reviewPly == null ? moves.length - 1
    : Math.min(S.reviewPly, moves.length - 1);
  return moves[i];
}
// player card for one side of the scorecard (reference PlayerCard.svelte)
function playerCardHTML(p, color) {
  const role = (p.role || "").replace("_static", "").replace("_fixed", "");
  return `<div class="player-card ${color}">
    <span class="stone"></span>
    <span class="pname">${p.name}</span>
    <span class="pmeta">${p.elo != null ? Math.round(p.elo) + " Elo" : ""}` +
    `${role ? " · " + role : ""}${p.architecture ? " · " + p.architecture : ""}</span>
  </div>`;
}

// match scorecard above the board: both players + game progress
// (reference MatchScorecard.svelte)
function renderScorecard(m) {
  const el = document.getElementById("sc-scorecard");
  if (!el) return;
  const sc = KT.scorecard(S.showcase.game, S.league.entries,
                          m ? m.ply : null);
  if (!sc) { el.innerHTML = ""; return; }
  el.innerHTML = `<div class="scorecard">
    ${playerCardHTML(sc.black, "black")}
    <span class="vs">vs</span>
    ${playerCardHTML(sc.white, "white")}
    <div class="progress" title="game progress (vs typical length)">
      <span style="width:${Math.round(sc.progress * 100)}%"></span>
    </div>
  </div>`;
}

// screen-reader move announcer (reference ShowcaseView aria-live region):
// announce only when the displayed ply changes, never on poll re-renders
let lastAnnouncedPly = null;
function announceMove(m, dots) {
  const el = document.getElementById("sc-announcer");
  if (!el || !m || m.ply === lastAnnouncedPly) return;
  lastAnnouncedPly = m.ply;
  const q = dots && dots[dots.length - 1];
  el.textContent = `ply ${m.ply}: ${moverOf(m)} played ${m.usi_notation}` +
    (m.in_check ? ", check" : "") +
    (q && q !== "normal" ? `, ${q}` : "");
}

function renderShowcase() {
  renderShowcaseStatus(); renderQueue();
  document.getElementById("sc-offline").classList.toggle(
    "hidden", !!S.showcase.alive);
  if (!views.showcase.classList.contains("active")) return;
  const moves = S.showcase.moves;
  const m = displayedMove();
  renderScorecard(m);
  document.getElementById("sc-live").setAttribute(
    "aria-pressed", String(S.reviewPly == null));
  const boardEl = document.getElementById("sc-board");
  const slider = document.getElementById("sc-slider");
  slider.max = Math.max(moves.length - 1, 0);
  if (S.reviewPly == null) slider.value = slider.max;

  if (m) {
    // heatmap overlay: {usi: prob} of the policy over moves sharing the
    // chosen move's source square (runner.build_heatmap)
    const heat = document.getElementById("sc-heat").checked && m.move_heatmap_json
      ? KT.heatCells(m.move_heatmap_json) : null;
    const dest = KT.usiDestCell(m.move_usi || m.usi_notation || "");
    boardEl.innerHTML =
      `<div class="meta">ply ${m.ply} · ${moverOf(m)} played ${m.usi_notation}` +
      `${m.in_check ? " · <b>check</b>" : ""}` +
      `${S.reviewPly != null ? " · <i>review</i>" : ""}</div>` +
      coordWrap(boardHTML(KT.safeParse(m.board_json, []), heat, dest)) +
      handsHTML(KT.safeParse(m.hands_json, {}));
    const p = blackProb(m);
    if (p != null) {
      document.getElementById("sc-evalfill").style.width = `${Math.round(p * 100)}%`;
      document.getElementById("sc-evaltext").textContent =
        `black ${(p * 100).toFixed(0)}%`;
    }
    const idx = moves.indexOf(m);
    announceMove(m, KT.moveDots(moves.slice(0, idx + 1)));
  } else {
    boardEl.innerHTML = '<p style="color:var(--dim)">no active showcase game</p>';
  }

  // win-probability graph over plies with a review marker
  drawChart("c-winprob",
    [{ color: "#63c57f", points: moves.map(x => [x.ply, blackProb(x)]) }],
    { unit: [0, 1], marker: m ? m.ply : null });

  // commentary: top policy candidates at the displayed ply
  const comm = document.getElementById("sc-commentary");
  let cands = [];
  if (m && m.top_candidates) {
    cands = KT.safeParse(m.top_candidates, []);
  }
  comm.innerHTML = m
    ? `<h4>Policy preferences · ply ${m.ply}</h4>` +
      (cands.length ? cands.map(([usi, p]) =>
        `<div class="cand-bar"><span class="lab">${usi}</span>` +
        `<span class="bar" style="width:${Math.round(p * 180)}px"></span>` +
        `<span class="pct">${(p * 100).toFixed(1)}%</span></div>`).join("")
      : '<span style="color:var(--dim)">no candidate data</span>')
    : "";

  // per-side match stats banner (reference ShowcaseStatsBanner)
  const stats = KT.showcaseStats(moves);
  const statCell = (side) =>
    `<span class="side-${side}">${side === "black" ? "●" : "○"} ` +
    `${stats[side].captures}x · ${stats[side].drops}* · ` +
    `+${stats[side].promotions} · ${stats[side].checks}✓</span>`;
  const banner = document.getElementById("sc-stats");
  if (banner) {
    banner.innerHTML = moves.length
      ? `${statCell("black")} ${statCell("white")}` +
        '<span class="hint"> captures · drops · promotions · checks</span>'
      : "";
  }

  // per-move quality dots from win-prob swings (reference MoveDots)
  const dots = KT.moveDots(moves);
  const idx = m ? moves.indexOf(m) : -1;
  document.getElementById("sc-moves").innerHTML =
    moves.map((x, i) =>
      `<li data-i="${i}" class="${i === idx ? "current" : ""}">` +
      `${dots[i] ? `<span class="dot ${dots[i]}" title="${dots[i]}"></span>` : ""}` +
      `${x.usi_notation}</li>`
    ).join("");
  for (const li of document.querySelectorAll("#sc-moves li")) {
    li.onclick = () => {
      const i = parseInt(li.dataset.i, 10);
      S.reviewPly = i === moves.length - 1 ? null : i;
      renderShowcase();
    };
  }
}

// ---------------------------------------------------------------------------
// about view (reference AboutView + aboutLevel store): a five-level
// progressive article. Each section declares the minimum detail level at
// which it appears; the switcher reveals deeper sections without hiding
// the ones already read. Pure level/TOC logic lives in lib.js.
// ---------------------------------------------------------------------------
const ABOUT_SECTIONS = [
  { id: "ab-big-idea", label: "The big idea", minLevel: 1, section: null,
    html: `
    <h2>What am I looking at?</h2>
    <p>This dashboard watches a computer teach itself <b>shogi</b> (Japanese
    chess) from scratch. It knows only the rules. It plays hundreds of games
    against itself at once on a TPU, looks at who won, and nudges its neural
    network so the moves that led to wins become a little more likely. Repeat
    a few million times and a random mover becomes a strong player — with no
    human games, openings, or advice involved.</p>
    <ul>
      <li><b>Training</b> — learning-progress charts. Losses should drift
      down; entropy measures how "undecided" the policy still is.</li>
      <li><b>Boards</b> — live positions sampled from the parallel self-play
      games, updating as they are played.</li>
      <li><b>League</b> — frozen snapshots of past versions play matches
      against the current learner, so progress is measured in Elo against
      real opponents, not just loss curves.</li>
      <li><b>Showcase</b> — watchable exhibition games between any two league
      members, with the network's win-probability estimate and its preferred
      moves overlaid.</li>
    </ul>
    <p>Shogi basics for the boards here: pieces point toward their opponent,
    and a captured piece switches sides — it goes to the capturer's
    <i>hand</i> (shown under the board) and can later be <i>dropped</i> back
    onto almost any empty square as their own. Drops keep material on the
    board forever, which is why shogi games almost never fizzle into empty
    endgames.</p>` },

  { id: "ab-self-play", label: "Self-play loop", minLevel: 2,
    section: "Level 2 · The learning loop", html: `
    <h3>The self-play loop</h3>
    <p>Training alternates two phases, both running on the TPU:</p>
    <ol>
      <li><b>Rollout.</b> A batch of games (the flagship runs 256 at once)
      advances some number of plies. At every position the network outputs a
      probability for each legal move, and one is <i>sampled</i> — not the
      best one, deliberately. The randomness is the exploration: it is how
      the learner stumbles into positions it would never choose yet, and
      how it keeps discovering better moves than its current favorites.</li>
      <li><b>Update.</b> The recorded positions, moves, and eventual results
      become one training batch. Moves that preceded better-than-expected
      outcomes get reinforced; the value estimate is pulled toward what
      actually happened. Then the improved network plays the next rollout.</li>
    </ol>
    <p>There is no database of expert games and no search tree at training
    time — improvement comes entirely from the gap between what the network
    expected and what its own games delivered.</p>
    <svg class="about-svg" viewBox="0 0 760 210" role="img"
         aria-labelledby="loop-t loop-d">
      <title id="loop-t">Self-play loop</title>
      <desc id="loop-d">Network produces masked move probabilities, an
      action is sampled, the rules engine applies it and returns the next
      observation; transitions accumulate in an on-device buffer consumed
      by the PPO update, which writes new weights back to the
      network.</desc>
      <defs><marker id="ab-arr" viewBox="0 0 10 10" refX="9" refY="5"
        markerWidth="7" markerHeight="7" orient="auto-start-reverse">
        <path d="M0,0 L10,5 L0,10 z" class="ab-arrhead"/></marker></defs>
      <rect x="6" y="6" width="560" height="198" rx="10" class="ab-region"/>
      <text x="286" y="198" text-anchor="middle" class="ab-n">one fused
        lax.scan program on the TPU — the host never enters this loop</text>
      <rect x="30" y="60" width="150" height="64" rx="8" class="ab-box"/>
      <text x="105" y="86" text-anchor="middle" class="ab-t">SE-ResNet</text>
      <text x="105" y="103" text-anchor="middle" class="ab-n">bf16 forward
        on the MXU</text>
      <rect x="390" y="60" width="150" height="64" rx="8" class="ab-box"/>
      <text x="465" y="86" text-anchor="middle" class="ab-t">Rules engine</text>
      <text x="465" y="103" text-anchor="middle" class="ab-n">dense legality,
        branchless</text>
      <path d="M180 76 H 388" class="ab-arrow" marker-end="url(#ab-arr)"/>
      <text x="285" y="68" text-anchor="middle" class="ab-n">sampled action
        (masked)</text>
      <path d="M390 108 H 182" class="ab-arrow" marker-end="url(#ab-arr)"/>
      <text x="285" y="126" text-anchor="middle" class="ab-n">observation +
        legal mask</text>
      <rect x="600" y="28" width="140" height="56" rx="8" class="ab-box"/>
      <text x="670" y="51" text-anchor="middle" class="ab-t">Buffer</text>
      <text x="670" y="68" text-anchor="middle" class="ab-n">on-device
        trajectory</text>
      <path d="M540 70 C 570 60, 580 56, 598 54" class="ab-arrow"
        marker-end="url(#ab-arr)"/>
      <rect x="600" y="124" width="140" height="56" rx="8" class="ab-box"/>
      <text x="670" y="147" text-anchor="middle" class="ab-t">PPO update</text>
      <text x="670" y="164" text-anchor="middle" class="ab-n">fused GAE +
        minibatch scan</text>
      <path d="M670 84 V 122" class="ab-arrow" marker-end="url(#ab-arr)"/>
      <path d="M600 170 C 300 200, 120 170, 103 126" class="ab-arrow ab-dash"
        marker-end="url(#ab-arr)"/>
      <text x="330" y="176" text-anchor="middle" class="ab-n">new weights for
        the next rollout</text>
    </svg>` },

  { id: "ab-league", label: "Why a league?", minLevel: 2,
    section: "Level 2 · The learning loop", html: `
    <h3>Why a league?</h3>
    <p>Loss curves cannot answer the question that matters: <i>is it
    actually stronger than last week?</i> A falling loss can coexist with
    cyclic play (A beats B beats C beats A) or with forgetting. So the
    trainer periodically freezes a copy of itself into an opponent pool and
    keeps playing rated matches against that pool:</p>
    <ul>
      <li><b>Frontier</b> entries are the strongest snapshots so far — the
      bar to clear.</li>
      <li><b>Recent</b> entries are the last few snapshots — they catch
      regressions quickly.</li>
      <li><b>Dynamic</b> entries keep learning on their own (slowly, from
      their match experience), so the pool doesn't go stale between
      snapshots.</li>
      <li><b>Historical</b> milestones (epoch 1, 5, 10, 30, 100 …) are never
      retired; a periodic gauntlet against them measures absolute progress
      on a fixed yardstick.</li>
    </ul>
    <p>Every match updates Elo ratings exactly as in human chess. The league
    table, matchup matrix, and Elo chart on the League tab are this system's
    scoreboard.</p>` },

  { id: "ab-observation", label: "What the network sees", minLevel: 3,
    section: "Level 3 · Inside the network", html: `
    <h3>What the network sees</h3>
    <p>Each position is encoded as a <b>50-plane 9×9 tensor</b>, always from
    the side-to-move's point of view (the board is flipped for White, so the
    network only ever learns "my pawns push up"):</p>
    <ul>
      <li>28 planes: one per piece kind × side on the board (14 kinds each
      way, promoted pieces separate).</li>
      <li>14 planes: pieces in hand, encoded as constant planes scaled by
      count (7 droppable kinds per side).</li>
      <li>8 planes: game context — ply number, a constant-ones plane, and
      repetition/check indicators.</li>
    </ul>
    <p>No move history stack and no handcrafted features beyond these:
    attack maps, king safety, and material balance are all things the
    network must discover for itself in its hidden layers.</p>` },

  { id: "ab-architecture", label: "Network architecture", minLevel: 3,
    section: "Level 3 · Inside the network", html: `
    <h3>Network architecture</h3>
    <p>The flagship model is a <b>40-block, 256-channel SE-ResNet</b>
    (~7.65 GFLOP per position) — a stack of identical residual blocks over
    the 9×9 board, the same family AlphaZero and KataGo use. Convolutions
    see only 3×3 neighborhoods, but 40 blocks of them give every square a
    view of the whole board many times over; depth is what lets "my rook is
    aimed at a weak pawn eight squares away" become a local feature.</p>
    <p>Smaller models (10×128) train the fast demo configs, and the model
    registry also carries MLP / scalar-ResNet / tiny-transformer baselines
    used by the test suite. All run in bfloat16 on the TPU's matrix units
    with float32 only where numerics demand it.</p>
    <svg class="about-svg" viewBox="0 0 760 290" role="img"
         aria-labelledby="arch-t arch-d">
      <title id="arch-t">Network architecture</title>
      <defs><marker id="ab-arr2" viewBox="0 0 10 10" refX="9" refY="5"
        markerWidth="7" markerHeight="7" orient="auto-start-reverse">
        <path d="M0,0 L10,5 L0,10 z" class="ab-arrhead"/></marker></defs>
      <desc id="arch-d">Observation tensor flows through a stem convolution
      and a 40-block SE-ResNet trunk, then splits into a spatial policy
      head and, via a global pool, the value and score heads.</desc>
      <rect x="255" y="10" width="250" height="38" rx="8" class="ab-box"/>
      <text x="380" y="34" text-anchor="middle" class="ab-t">Observation
        (B, 50, 9, 9)</text>
      <path d="M380 48 V 66" class="ab-arrow" marker-end="url(#ab-arr2)"/>
      <rect x="255" y="68" width="250" height="38" rx="8" class="ab-box"/>
      <text x="380" y="92" text-anchor="middle" class="ab-t">Stem: conv 3×3
        → BN → ReLU</text>
      <path d="M380 106 V 124" class="ab-arrow" marker-end="url(#ab-arr2)"/>
      <rect x="243" y="134" width="274" height="50" rx="8" class="ab-box ab-ghost"/>
      <rect x="249" y="130" width="274" height="50" rx="8" class="ab-box ab-ghost"/>
      <rect x="255" y="126" width="274" height="50" rx="8" class="ab-box"/>
      <text x="392" y="148" text-anchor="middle" class="ab-t">Trunk: 40 ×
        SE-ResNet block</text>
      <text x="392" y="166" text-anchor="middle" class="ab-n">256 channels,
        bf16, ~7.65 GFLOP/position</text>
      <path d="M300 184 C 240 204, 180 208, 160 218" class="ab-arrow"
        marker-end="url(#ab-arr2)"/>
      <path d="M400 184 V 216" class="ab-arrow" marker-end="url(#ab-arr2)"/>
      <rect x="60" y="220" width="200" height="58" rx="8" class="ab-box"/>
      <text x="160" y="244" text-anchor="middle" class="ab-t">Policy head</text>
      <text x="160" y="262" text-anchor="middle" class="ab-n">1×1 convs →
        81×139 = 11,259 logits</text>
      <rect x="310" y="220" width="180" height="58" rx="8" class="ab-box"/>
      <text x="400" y="244" text-anchor="middle" class="ab-t">Global pool</text>
      <text x="400" y="262" text-anchor="middle" class="ab-n">board mean +
        max per channel</text>
      <path d="M490 244 H 538" class="ab-arrow" marker-end="url(#ab-arr2)"/>
      <rect x="540" y="192" width="190" height="44" rx="8" class="ab-box"/>
      <text x="635" y="212" text-anchor="middle" class="ab-t">Value head</text>
      <text x="635" y="228" text-anchor="middle" class="ab-n">win / draw /
        loss (fp32)</text>
      <rect x="540" y="244" width="190" height="44" rx="8" class="ab-box"/>
      <text x="635" y="264" text-anchor="middle" class="ab-t">Score head</text>
      <text x="635" y="280" text-anchor="middle" class="ab-n">material-lead
        estimate (fp32)</text>
    </svg>` },

  { id: "ab-block", label: "Inside a block", minLevel: 3,
    section: "Level 3 · Inside the network", html: `
    <h3>Inside a residual block</h3>
    <p>Each block is conv→norm→ReLU→conv→norm plus the skip connection that
    makes 40-deep stacks trainable. Two additions, both borrowed from
    KataGo's playbook, matter for board games:</p>
    <ul>
      <li><b>Squeeze-and-excitation (the "SE")</b>: the block pools its own
      output over the board, passes that through a tiny two-layer net, and
      uses the result to re-weight its channels. It is a cheap global
      attention: "there's an attack brewing on the king's side, turn up the
      king-safety channels everywhere".</li>
      <li><b>Global-pool bias</b>: a parallel path pools board-wide averages
      and maxima and feeds them back as per-channel biases, so global state
      (material count, phase of the game) reaches every square without
      needing 40 layers of propagation.</li>
    </ul>
    <svg class="about-svg" viewBox="0 0 760 170" role="img"
         aria-labelledby="blk-t blk-d">
      <title id="blk-t">Inside a residual block</title>
      <defs><marker id="ab-arr3" viewBox="0 0 10 10" refX="9" refY="5"
        markerWidth="7" markerHeight="7" orient="auto-start-reverse">
        <path d="M0,0 L10,5 L0,10 z" class="ab-arrhead"/></marker></defs>
      <desc id="blk-d">Input passes through two convolution-normalization
      stages; a squeeze-and-excitation path pools the board, computes
      per-channel weights through a two-layer net, and rescales the output
      before the skip connection is added back.</desc>
      <rect x="10" y="60" width="80" height="44" rx="8" class="ab-box"/>
      <text x="50" y="86" text-anchor="middle" class="ab-t">input</text>
      <path d="M90 82 H 118" class="ab-arrow" marker-end="url(#ab-arr3)"/>
      <rect x="120" y="60" width="140" height="44" rx="8" class="ab-box"/>
      <text x="190" y="79" text-anchor="middle" class="ab-t">conv 3×3</text>
      <text x="190" y="96" text-anchor="middle" class="ab-n">BN → ReLU</text>
      <path d="M260 82 H 288" class="ab-arrow" marker-end="url(#ab-arr3)"/>
      <rect x="290" y="60" width="140" height="44" rx="8" class="ab-box"/>
      <text x="360" y="79" text-anchor="middle" class="ab-t">conv 3×3</text>
      <text x="360" y="96" text-anchor="middle" class="ab-n">BN</text>
      <path d="M430 82 H 458" class="ab-arrow" marker-end="url(#ab-arr3)"/>
      <rect x="460" y="60" width="130" height="44" rx="8" class="ab-box"/>
      <text x="525" y="79" text-anchor="middle" class="ab-t">SE rescale</text>
      <text x="525" y="96" text-anchor="middle" class="ab-n">per-channel ×</text>
      <rect x="430" y="10" width="200" height="36" rx="8" class="ab-box ab-side"/>
      <text x="530" y="33" text-anchor="middle" class="ab-n">pool board →
        2-layer net → channel weights</text>
      <path d="M400 60 C 410 40, 420 32, 428 28" class="ab-arrow"/>
      <path d="M550 46 V 58" class="ab-arrow" marker-end="url(#ab-arr3)"/>
      <path d="M590 82 H 638" class="ab-arrow" marker-end="url(#ab-arr3)"/>
      <circle cx="655" cy="82" r="15" class="ab-box"/>
      <text x="655" y="87" text-anchor="middle" class="ab-t">+</text>
      <path d="M50 104 C 50 150, 600 150, 650 97" class="ab-arrow ab-dash"
        marker-end="url(#ab-arr3)"/>
      <text x="350" y="158" text-anchor="middle" class="ab-n">skip connection
        — the gradient highway that makes 40 blocks trainable</text>
      <path d="M670 82 H 708" class="ab-arrow" marker-end="url(#ab-arr3)"/>
      <text x="730" y="87" text-anchor="middle" class="ab-t">ReLU</text>
    </svg>` },

  { id: "ab-heads", label: "Three heads", minLevel: 3,
    section: "Level 3 · Inside the network", html: `
    <h3>Three output heads</h3>
    <p>The trunk feeds three small heads, trained jointly:</p>
    <ul>
      <li><b>Policy</b> — a distribution over all <b>11,259</b> representable
      actions (81 destination squares × 139 move types: 64 queen-like rides
      ×2 for promotion, 2 knight moves ×2, and 7 drop kinds). Illegal moves
      are masked to exactly zero before sampling, so the network never
      wastes probability on them.</li>
      <li><b>Value</b> — win/draw/loss probabilities for the side to move,
      read as the eval bar and win-probability graph in the Showcase
      view.</li>
      <li><b>Score</b> — a material-lead estimate. Games that end in
      checkmate teach it little, but it gives the value head a dense,
      early-available learning signal (KataGo's trick).</li>
    </ul>` },

  { id: "ab-ppo", label: "PPO objective", minLevel: 4,
    section: "Level 4 · The algorithm", html: `
    <h3>The objective: PPO, KataGo-flavoured</h3>
    <p>Updates use <b>Proximal Policy Optimization</b>: for each recorded
    move, compare the new policy's probability to the one that actually
    played it (the ratio <code>r</code>), multiply by the move's
    <i>advantage</i> (how much better the outcome was than the value head
    expected), and clip <code>r</code> to <code>[1−ε, 1+ε]</code> so no
    single batch can yank the policy far from the one that generated the
    data. Several epochs of minibatch steps re-use each rollout before it
    is discarded as off-policy.</p>
    <p>The full loss adds the value head's cross-entropy against real
    outcomes, the score head's regression (weighted low), and an entropy
    bonus that decays on a schedule — early on it props exploration up,
    later it lets the policy sharpen. All components are computed under the
    legality mask, so probabilities over illegal moves never contribute
    gradient.</p>` },

  { id: "ab-credit", label: "Credit assignment", minLevel: 4,
    section: "Level 4 · The algorithm", html: `
    <h3>Credit assignment in an alternating game</h3>
    <p>Advantages come from <b>Generalized Advantage Estimation</b>: a
    λ-weighted sum of temporal-difference errors that trades variance
    against bias. Self-play adds a twist a single-agent recipe gets silently
    wrong: consecutive plies belong to <i>opposite players</i>, and every
    stored value is from its mover's perspective. The λ-chain here therefore
    <b>negates its carry at every step</b> (negamax-style): the opponent's
    pleasant surprise is exactly my unpleasant one. At γ=λ=1 the recursion
    provably reproduces each mover's true game outcome — a property pinned
    by tests, and a real bug class this build fixed along the way.</p>
    <p>Games truncated at the max-ply ceiling bootstrap from the value head
    instead of leaking a fake "draw" signal, and environment auto-resets cut
    the chain so credit never flows across game boundaries.</p>` },

  { id: "ab-knobs", label: "Knobs that matter", minLevel: 4,
    section: "Level 4 · The algorithm", html: `
    <h3>The knobs that actually matter</h3>
    <ul>
      <li><b>Batch geometry</b>: 256 parallel games × 128 plies per epoch =
      32,768 samples per update; minibatches of 1024 on the flagship.</li>
      <li><b>Learning rate</b> 2e-4 with a plateau scheduler (halve when
      policy loss stalls; the scheduler's state survives checkpoint
      resume).</li>
      <li><b>Clip ε</b> 0.2, <b>γ</b> 0.99, <b>λ</b> 0.95 — the PPO
      classics; γ&lt;1 mostly acts as a horizon prior in a game this
      long.</li>
      <li><b>Entropy schedule</b>: linear decay with a floor; watching the
      entropy chart against the win-rate chart is the fastest health check
      this dashboard offers.</li>
      <li><b>Gradient clip</b> at global-norm 1.0 — the g-norm chart shows
      how often it engages.</li>
    </ul>
    <p>The config file (hover the ⚙ summary in the header) records every
    one of these per run; unknown keys are rejected at load time rather
    than silently ignored.</p>` },

  { id: "ab-framing", label: "Problem framing", minLevel: 5,
    section: "Level 5 · Research view", html: `
    <h3>Problem framing</h3>
    <p>Formally: a two-player zero-sum, perfect-information Markov game,
    solved approximately by <b>self-play policy iteration without
    search</b> — one network is both players, and the opponent improves
    exactly as fast as the learner because it <i>is</i> the learner. That
    makes the learning target non-stationary by construction; the league
    exists to keep that moving target honest (fixed anchors, diverse
    opponents) rather than to provide training data.</p>
    <p>Contrast with AlphaZero: no MCTS at either training or play time.
    The policy head must carry the entire burden tactics included, which
    is a harder representation problem and a deliberately different point
    in the design space — every position costs exactly one forward pass,
    so throughput, not search efficiency, is the currency.</p>` },

  { id: "ab-tpu", label: "Mapping to the TPU", minLevel: 5,
    section: "Level 5 · Research view", html: `
    <h3>Mapping to the TPU</h3>
    <p>The defining constraint: a TPU wants one large, static-shaped,
    compiled program — not a Python game loop. So the rules engine is not
    ported, it is <i>re-derived</i>: game state is a tensor pytree, and
    legality for all 11,259 actions of all 256 games is computed as one
    branchless dense program (precomputed attack tables, 8-direction shift
    floods, one-hot einsums that run on the matrix units). Rollout and PPO
    update fuse into a single <code>lax.scan</code> program per epoch; the
    host only touches the league bookkeeping and this dashboard's SQLite
    bus.</p>
    <p>Measured consequence: the rules engine contributes ~7% of step time;
    the other ~93% is SE-ResNet inference running near the chip's bf16
    peak — i.e. the framework is model-bound, which is exactly where a
    self-play system wants to be. Multi-chip runs shard the game batch over
    a device mesh (data parallel, XLA collectives); the league tier is
    deliberately single-host, matching the reference's constraint.</p>` },

  { id: "ab-limitations", label: "Limitations", minLevel: 5,
    section: "Level 5 · Research view", html: `
    <h3>Honest limitations</h3>
    <ul>
      <li><b>No search.</b> Without test-time lookahead, deep tactics cap
      the attainable strength well below search-based engines; Elo here
      measures progress against this system's own history, not against
      Stockfish-class play.</li>
      <li><b>Sampled, not exhaustive, evaluation.</b> League matches are a
      noisy estimator; Elo error bars shrink only with match count, and the
      scheduler's coverage heuristics are just that.</li>
      <li><b>Single-host league.</b> Pool bookkeeping (Elo, tiers, SQLite)
      lives on one host; multi-host data parallelism and league mode are
      mutually exclusive by design.</li>
      <li><b>Draw handling.</b> Repetition and impasse rules are exact, but
      max-ply truncation is still an artificial horizon; its rate is
      charted because it subtly shapes the value target.</li>
    </ul>` },
];

function renderAbout() {
  const lvl = KT.clampAboutLevel(parseInt(prefs.aboutLevel, 10));
  const levels = KT.ABOUT_LEVELS;
  const meta = levels.find(l => l.id === lvl);
  // level switcher
  document.getElementById("about-levelbar").innerHTML =
    `<div class="level-btns" role="radiogroup" aria-label="detail level">` +
    levels.map(l =>
      `<button data-lvl="${l.id}" role="radio"` +
      ` aria-checked="${l.id === lvl}"` +
      ` class="${l.id === lvl ? "active" : ""}"` +
      ` title="${l.blurb}">${l.id} · ${l.label}</button>`).join("") +
    `</div>` +
    `<div class="level-meta">Level ${lvl} of ${levels.length} — ` +
    `${meta.blurb}. <span class="hint">(+/− to change)</span></div>` +
    `<div class="level-progress"><span style="width:${(lvl / levels.length) * 100}%"></span></div>`;
  for (const btn of document.querySelectorAll("#about-levelbar button"))
    btn.onclick = () => { prefs.aboutLevel = btn.dataset.lvl; renderAbout(); };
  // table of contents, grouped by level section
  const visible = KT.visibleAboutToc(ABOUT_SECTIONS, lvl);
  document.getElementById("about-toc").innerHTML =
    KT.groupToc(visible).map(g =>
      (g.section ? `<div class="toc-section">${g.section}</div>` : "") +
      g.items.map(it =>
        `<a href="#${it.id}">${it.label}</a>`).join("")).join("");
  // body: all sections visible at this level, in declaration order
  document.getElementById("about-body").innerHTML =
    visible.map(s => `<section class="about-sec" id="${s.id}">${s.html}</section>`)
      .join("");
  renderLegend();
}

// piece-movement legend (reference ShogiLegend + MoveDots): one card per
// piece, base movement on the left, promoted (if any) on the right
function moveDotsHTML(grid) {
  if (!grid) return "";
  // arrows point outward from the center for slides; knight leap gets ↑↑
  const SLIDE = [["↖", "↑", "↗"], ["←", "", "→"], ["↙", "↓", "↘"]];
  let html = '<div class="movedots">';
  for (let r = 0; r < 3; r++)
    for (let c = 0; c < 3; c++) {
      const v = grid[r][c];
      const glyph = r === 1 && c === 1 ? "·"
        : v === "step" ? "■" : v === "slide" ? SLIDE[r][c]
        : v === "jump" ? "↟" : "";
      html += `<span class="${v || "none"}">${glyph}</span>`;
    }
  return html + "</div>";
}
function renderLegend() {
  const el = document.getElementById("shogi-legend");
  if (!el) return;
  const kinds = ["pawn", "lance", "knight", "silver", "gold",
                 "bishop", "rook", "king"];
  el.innerHTML = kinds.map(k => {
    const base = KT.movePattern(k, false);
    const promo = KT.movePattern(k, true);
    const name = k[0].toUpperCase() + k.slice(1);
    const ch = (p) => KT.pieceChar({ type: k, promoted: p }, prefs.notation);
    return `<div class="legend-card">
      <div class="legend-name">${name}</div>
      <div class="legend-row">
        <div><div class="legend-piece">${ch(false)}</div>${moveDotsHTML(base)}</div>
        ${promo ? `<div><div class="legend-piece promoted">${ch(true)}</div>${moveDotsHTML(promo)}</div>` : ""}
      </div>
    </div>`;
  }).join("");
}

// ---------------------------------------------------------------------------
// navigation + controls
// ---------------------------------------------------------------------------
const views = {};
for (const sec of document.querySelectorAll(".view"))
  views[sec.id.replace("view-", "")] = sec;
for (const btn of document.querySelectorAll("nav button")) {
  btn.onclick = () => {
    document.querySelectorAll("nav button").forEach(b => b.classList.remove("active"));
    document.querySelectorAll(".view").forEach(v => v.classList.remove("active"));
    btn.classList.add("active");
    views[btn.dataset.view].classList.add("active");
    renderAll();
  };
}
document.getElementById("sc-request").onclick = () => send({
  type: "request_showcase_match",
  entry_id_1: document.getElementById("sc-e1").value,
  entry_id_2: document.getElementById("sc-e2").value,
  speed: document.getElementById("sc-speed").value,
});
document.getElementById("sc-cancel").onclick = () => {
  const running = S.showcase.queue.find(q => q.status === "running") ||
                  S.showcase.queue[0];
  if (running) send({ type: "cancel_showcase_match", queue_id: running.id });
};
document.getElementById("sc-speed").onchange = (ev) => {
  const running = S.showcase.queue.find(q => q.status === "running");
  if (running) send({ type: "change_showcase_speed", queue_id: running.id,
                      speed: ev.target.value });
};
document.getElementById("sc-slider").oninput = (ev) => {
  const i = parseInt(ev.target.value, 10);
  S.reviewPly = i >= S.showcase.moves.length - 1 ? null : i;
  renderShowcase();
};
document.getElementById("sc-live").onclick = () => {
  S.reviewPly = null; renderShowcase();
};
document.getElementById("sc-heat").onchange = () => renderShowcase();
// keyboard move review: ←/→ step, Home = first, End = live (showcase view)
window.addEventListener("keydown", (ev) => {
  if (!views.showcase || !views.showcase.classList.contains("active")) return;
  if (/^(INPUT|SELECT|TEXTAREA)$/.test(document.activeElement?.tagName || "")) return;
  const n = S.showcase.moves.length;
  if (!n) return;
  const cur = S.reviewPly == null ? n - 1 : S.reviewPly;
  let next = null;
  if (ev.key === "ArrowLeft") next = Math.max(cur - 1, 0);
  else if (ev.key === "ArrowRight") next = Math.min(cur + 1, n - 1);
  else if (ev.key === "Home") next = 0;
  else if (ev.key === "End") next = n - 1;
  else return;
  ev.preventDefault();
  S.reviewPly = next >= n - 1 ? null : next;
  renderShowcase();
});
document.getElementById("boards-count").onchange = () => renderBoards();
// +/- adjust the about detail level while the About view is active
document.addEventListener("keydown", (ev) => {
  if (!views.about || !views.about.classList.contains("active")) return;
  if (ev.target.tagName === "INPUT" || ev.target.tagName === "SELECT") return;
  const delta = ev.key === "+" || ev.key === "=" ? 1
    : ev.key === "-" || ev.key === "_" ? -1 : 0;
  if (!delta) return;
  prefs.aboutLevel = String(KT.clampAboutLevel(
    KT.clampAboutLevel(parseInt(prefs.aboutLevel, 10)) + delta));
  renderAbout();
});
document.getElementById("toggle-theme").onclick = () => {
  prefs.theme = prefs.theme === "dark" ? "light" : "dark";
  applyTheme(); renderAll();
};
document.getElementById("toggle-notation").onclick = () => {
  prefs.notation = prefs.notation === "kanji" ? "letters" : "kanji";
  applyNotationBtn(); renderAll();
};
document.getElementById("toggle-sound").onclick = () => {
  prefs.sound = !prefs.sound;
  applySoundBtn();
};
document.getElementById("toggle-smooth").onclick = () => {
  prefs.smooth = !prefs.smooth;
  applySmoothBtn(); renderCharts();
};

function renderAll() {
  renderStatus(); renderCharts(); renderBoards(); renderLeague();
  fillShowcaseSelectors(); renderShowcase(); renderAbout();
}
window.addEventListener("resize", () => { renderCharts(); renderLeague(); });
applyTheme(); applyNotationBtn(); applySoundBtn(); applySmoothBtn();
connect();
