/* mixlab-tpu web client.
 *
 * Rebuild of the reference's Yew/WASM frontend (frontend/src/, ~4.9k LoC
 * Rust) as a dependency-free JS app:
 *   - session WebSocket with the wire.py JSON protocol
 *   - local workspace mirror with optimistic updates + Sync gating
 *     (frontend/src/session.rs:83-177 semantics)
 *   - canvas/SVG graph editor: draggable module windows, z-order,
 *     click-to-connect terminals with line-type checking, right-click
 *     create menu (frontend/src/workspace.rs)
 *   - per-module param UIs incl. plotter scope, monitor player
 *     (WebAudio PCM + PNG frames), stream output impulse controls
 *   - WebMIDI broker with learn-mode CC mapping (frontend/src/service/midi.rs)
 *   - performance sidebar (frontend/src/sidebar.rs)
 *   - media library with upload (frontend/src/library.rs)
 */
"use strict";

/* ------------------------------------------------------------------ wire */

const wire = {
  seq: 0,
  send(op) {
    wire.seq += 1;
    session.core.pendingSeq = wire.seq;
    session.ws.send(JSON.stringify({
      v: 1, kind: "Workspace", m: { sequence: wire.seq, op },
    }));
    return wire.seq;
  },
};

const LINE_COLORS = { mono: "#6ab0f3", stereo: "#7c4", video: "#e6a23c" };

const CREATABLE = [
  ["Oscillator", () => ({ kind: "Oscillator", params: { t: "OscillatorParams", freq: 220.0, waveform: "sine" } })],
  ["FmSine", () => ({ kind: "FmSine", params: { t: "FmSineParams", freq_lo: 90.0, freq_hi: 110.0 } })],
  ["Amplifier", () => ({ kind: "Amplifier", params: { t: "AmplifierParams", amplitude: 1.0, mod_depth: 0.0 } })],
  ["Envelope", () => ({ kind: "Envelope", params: { t: "EnvelopeParams", attack_ms: 25.0, decay_ms: 500.0, sustain_amplitude: 0.8, release_ms: 200.0 } })],
  ["EqThree", () => ({ kind: "EqThree", params: { t: "EqThreeParams", gain_lo: 0.0, gain_mid: 0.0, gain_hi: 0.0 } })],
  ["Mixer (4ch)", () => ({ kind: "Mixer", params: { t: "MixerParams", channels: [0, 1, 2, 3].map(() => ({ t: "MixerChannelParams", gain: 0.0, fader: 1.0, cue: false })) } })],
  ["StereoPanner", () => ({ kind: "StereoPanner", params: null })],
  ["StereoSplitter", () => ({ kind: "StereoSplitter", params: null })],
  ["Trigger", () => ({ kind: "Trigger", params: "closed" })],
  ["Plotter", () => ({ kind: "Plotter", params: null })],
  ["Monitor", () => ({ kind: "Monitor", params: null })],
  ["StreamInput", () => ({ kind: "StreamInput", params: { t: "StreamInputParams", protocol: null, mountpoint: null } })],
  ["StreamOutput", () => ({ kind: "StreamOutput", params: { t: "StreamOutputParams", seq: 1, connect_seq: 0, disconnect_seq: 0, rtmp_url: "", rtmp_stream_key: "" } })],
  ["VideoMixer", () => ({ kind: "VideoMixer", params: { t: "VideoMixerParams", a: null, b: null, fader: 1.0 } })],
  ["MediaSource", () => ({ kind: "MediaSource", params: { t: "MediaSourceParams", media_id: null } })],
  ["OutputDevice", () => ({ kind: "OutputDevice", params: { t: "OutputDeviceParams", device: null, left: null, right: null } })],
];

/* --------------------------------------------------------------- session */

/* The mirror + optimistic-sync logic lives in session_core.js (pure,
 * DOM-free, executed under test by mixlab_tpu.utils.jsmini); this object
 * owns the WebSocket and bridges core hooks to the DOM layers.  Render
 * gating matches frontend/src/session.rs:83-108: server updates always
 * apply to the mirror but re-render only once the server has caught up to
 * our local edits; the catching-up Sync fires the deferred render. */
const session = {
  ws: null,
  state: null,
  media: [],
  perf: null,
  onchange: [],
  core: makeSessionCore({
    render: () => {
      session.state = session.core.state;
      notify();
    },
    onIndication: (mid, ind) => indications.dispatch(mid, ind),
    onPerformance: (perf) => {
      session.perf = perf;
      sidebar.render();
    },
    onMediaLibrary: (items) => {
      session.media = items;
      library.render();
      notify();
    },
    geometryHeld: (mid) => drag.activeWindow === mid,
    onDeleteModule: (mid) => monitorPlayers.drop(mid),
  }),

  connect() {
    const ws = new WebSocket(`ws://${location.host}/session`);
    session.ws = ws;
    ws.onmessage = (ev) => session.onMessage(JSON.parse(ev.data));
    ws.onclose = () => setTimeout(() => session.connect(), 2000);
  },

  caughtUp() { return session.core.caughtUp(); },

  onMessage(msg) {
    session.core.onMessage(msg);
    session.state = session.core.state;
  },
};

function key(idArr) { return sessionKey(idArr); }
function notify() { for (const f of session.onchange) f(); }

/* ------------------------------------------------------------ indications */

const indications = {
  subs: new Map(), // moduleId -> fn
  dispatch(mid, ind) {
    const f = indications.subs.get(mid);
    if (f) f(ind);
  },
};

/* ------------------------------------------------------------- workspace */

const drag = { activeWindow: null, offset: null, pendingConnect: null };

const workspace = {
  el: null,
  svg: null,

  init() {
    workspace.el = document.getElementById("workspace");
    workspace.svg = document.getElementById("wires");
    workspace.el.addEventListener("contextmenu", (ev) => {
      ev.preventDefault();
      workspace.showCreateMenu(ev.clientX, ev.clientY);
    });
    workspace.el.addEventListener("click", () => {
      document.getElementById("ctxmenu").style.display = "none";
    });
    // live connect wire follows the cursor (workspace.rs:173-178)
    workspace.el.addEventListener("pointermove", (ev) => {
      if (!connectFlow.pending) return;
      const rect = workspace.el.getBoundingClientRect();
      connectFlow.move(ev.clientX - rect.left, ev.clientY - rect.top);
      workspace.renderWires();
    });
    // pressing empty workspace cancels a pending connect
    workspace.el.addEventListener("pointerdown", () => {
      if (connectFlow.pending) {
        connectFlow.cancel();
        setStatus("");
        workspace.renderWires();
      }
    });
    session.onchange.push(() => workspace.render());
  },

  showCreateMenu(x, y) {
    const menu = document.getElementById("ctxmenu");
    menu.innerHTML = "";
    for (const [label, make] of CREATABLE) {
      const item = document.createElement("div");
      item.className = "ctxitem";
      item.textContent = label;
      item.onclick = (ev) => {
        ev.stopPropagation();
        menu.style.display = "none";
        const rect = workspace.el.getBoundingClientRect();
        wire.send({
          t: "CreateModule",
          params: make(),
          geometry: { t: "WindowGeometry", position: { t: "Coords", x: Math.round(x - rect.left), y: Math.round(y - rect.top) }, z_index: nextZ() },
        });
      };
      menu.appendChild(item);
    }
    menu.style.left = `${x}px`;
    menu.style.top = `${y}px`;
    menu.style.display = "block";
  },

  render() {
    const s = session.state;
    if (!s) return;
    const el = workspace.el;
    // remove windows for deleted modules
    for (const win of [...el.querySelectorAll(".module")]) {
      if (!s.modules.has(parseInt(win.dataset.mid))) win.remove();
    }
    for (const [mid, params] of s.modules) {
      let win = el.querySelector(`.module[data-mid="${mid}"]`);
      if (!win) {
        win = windows.create(mid, params);
        el.appendChild(win);
      }
      windows.update(win, mid, params);
    }
    workspace.renderWires();
  },

  renderWires() {
    const s = session.state;
    const svg = workspace.svg;
    svg.innerHTML = "";
    if (!s) return;
    for (const [inpKey, out] of s.connections) {
      const [imid, iidx] = inpKey.split(":").map(Number);
      const a = terminalPos(out[0], out[1], "out");
      const b = terminalPos(imid, iidx, "in");
      if (!a || !b) continue;
      const path = document.createElementNS("http://www.w3.org/2000/svg", "path");
      const mx = (a.x + b.x) / 2;
      path.setAttribute("d", `M ${a.x} ${a.y} C ${mx} ${a.y}, ${mx} ${b.y}, ${b.x} ${b.y}`);
      path.setAttribute("class", "wire");
      path.setAttribute("stroke", a.color || "#888");
      path.onclick = () => wire.send({ t: "DeleteConnection", input_id: [imid, iidx] });
      svg.appendChild(path);
    }
    // live wire from the pending terminal to the cursor while connecting
    if (connectFlow.pending && connectFlow.cursor) {
      const p = connectFlow.pending;
      const a = terminalPos(p.mid, p.idx, p.dir);
      if (a) {
        const b = connectFlow.cursor;
        const path = document.createElementNS("http://www.w3.org/2000/svg", "path");
        const mx = (a.x + b.x) / 2;
        path.setAttribute("d", `M ${a.x} ${a.y} C ${mx} ${a.y}, ${mx} ${b.y}, ${b.x} ${b.y}`);
        path.setAttribute("class", "wire live");
        path.setAttribute("stroke", a.color || "#888");
        svg.appendChild(path);
      }
    }
  },
};

function terminalPos(mid, idx, dir) {
  const dot = workspace.el.querySelector(
    `.module[data-mid="${mid}"] .term.${dir}[data-idx="${idx}"]`);
  if (!dot) return null;
  const r = dot.getBoundingClientRect();
  const w = workspace.el.getBoundingClientRect();
  return {
    x: r.left - w.left + r.width / 2,
    y: r.top - w.top + r.height / 2,
    color: dot.dataset.color,
  };
}

function nextZ() {
  let z = 1;
  if (session.state) for (const g of session.state.geometry.values()) z = Math.max(z, (g.z_index || 0) + 1);
  return z;
}

/* --------------------------------------------------------------- windows */

const windows = {
  create(mid, params) {
    const win = document.createElement("div");
    win.className = "module";
    win.dataset.mid = mid;
    win.innerHTML = `
      <div class="titlebar"><span class="title"></span>
        <button class="close" title="delete">×</button></div>
      <div class="terms-in"></div><div class="body"></div><div class="terms-out"></div>`;
    win.querySelector(".close").onclick = () =>
      wire.send({ t: "DeleteModule", module_id: mid });
    const bar = win.querySelector(".titlebar");
    bar.addEventListener("pointerdown", (ev) => {
      if (ev.target.classList.contains("close")) return;
      drag.activeWindow = mid;
      const g = session.state.geometry.get(mid) || { position: { x: 0, y: 0 } };
      drag.offset = { x: ev.clientX - g.position.x, y: ev.clientY - g.position.y };
      bar.setPointerCapture(ev.pointerId);
    });
    bar.addEventListener("pointermove", (ev) => {
      if (drag.activeWindow !== mid || !drag.offset) return;
      const pos = { x: Math.round(ev.clientX - drag.offset.x), y: Math.round(ev.clientY - drag.offset.y) };
      const g = { t: "WindowGeometry", position: { t: "Coords", ...pos }, z_index: nextZ() };
      session.state.geometry.set(mid, g);
      win.style.left = `${pos.x}px`;
      win.style.top = `${pos.y}px`;
      workspace.renderWires();
    });
    bar.addEventListener("pointerup", () => {
      if (drag.activeWindow !== mid) return;
      const g = session.state.geometry.get(mid);
      drag.activeWindow = null;
      drag.offset = null;
      wire.send({ t: "UpdateWindowGeometry", module_id: mid, geometry: g });
    });
    moduleUI.build(win, mid, params);
    return win;
  },

  update(win, mid, params) {
    const s = session.state;
    const g = s.geometry.get(mid) || { position: { x: 10, y: 10 }, z_index: 0 };
    win.style.left = `${g.position.x}px`;
    win.style.top = `${g.position.y}px`;
    win.style.zIndex = g.z_index || 0;
    win.querySelector(".title").textContent = `${params.kind} #${mid}`;
    windows.renderTerminals(win, mid, "in", s.inputs.get(mid) || []);
    windows.renderTerminals(win, mid, "out", s.outputs.get(mid) || []);
    moduleUI.update(win, mid, params);
  },

  renderTerminals(win, mid, dir, terms) {
    const holder = win.querySelector(dir === "in" ? ".terms-in" : ".terms-out");
    if (holder.childElementCount !== terms.length) {
      holder.innerHTML = "";
      terms.forEach(([label, lineType], idx) => {
        const dot = document.createElement("div");
        dot.className = `term ${dir}`;
        dot.dataset.idx = idx;
        dot.dataset.color = LINE_COLORS[lineType] || "#888";
        dot.style.background = dot.dataset.color;
        dot.title = `${label || ""} (${lineType})`;
        dot.addEventListener("pointerdown", (ev) => {
          ev.stopPropagation();
          terminalDown(mid, idx, dir, lineType, ev);
        });
        dot.addEventListener("click", (ev) => ev.stopPropagation());
        dot.addEventListener("contextmenu", (ev) => {
          ev.preventDefault();
          ev.stopPropagation();
        });
        holder.appendChild(dot);
      });
    }
  },
};

/* drag/click-to-connect with a live wire, reference semantics
 * (workspace.rs:185-252): left-press a terminal (either direction) to
 * start, left-press a matching opposite terminal to connect; right-press
 * clears a terminal's connections.  State machine in session_core.js. */
const connectFlow = makeConnectFlow(session.core, (m) => wire.send(m));

function terminalDown(mid, idx, dir, lineType, ev) {
  const result = connectFlow.down(mid, idx, dir, lineType, ev.buttons);
  if (result === "pending") {
    setStatus(`connecting from ${mid}:${idx} (${lineType}) — pick the other end`);
  } else if (result === "mismatch") {
    setStatus(`type mismatch: ${connectFlow.pending.lineType} vs ${lineType}`, true);
  } else if (result === "invalid") {
    setStatus("pick one output and one input", true);
  } else {
    setStatus("");
  }
  workspace.renderWires();
}

function setStatus(text, warn) {
  const el = document.getElementById("status");
  el.textContent = text;
  el.className = warn ? "warn" : "";
}

/* ------------------------------------------------- canvas controls
 * Rebuild of frontend/src/control/{fader,rotary}.rs: canvas-drawn
 * continuous controls with pointer drag + wheel, MIDI-learnable. */

function makeFader(value, min, max, onChange) {
  const c = document.createElement("canvas");
  c.width = 28; c.height = 84;
  c.className = "fader";
  let v = value;
  const draw = () => {
    const ctx = c.getContext("2d");
    ctx.clearRect(0, 0, c.width, c.height);
    ctx.fillStyle = "#181d22";
    ctx.fillRect(11, 6, 6, c.height - 12);
    const t = (v - min) / (max - min);
    const y = 6 + (1 - t) * (c.height - 24);
    ctx.fillStyle = "#6ab0f3";
    ctx.fillRect(4, y, 20, 12);
  };
  const set = (nv, fire = true) => {
    v = Math.min(max, Math.max(min, nv));
    draw();
    if (fire) onChange(v);
  };
  let dragging = false;
  c.addEventListener("pointerdown", (ev) => {
    dragging = true; c.setPointerCapture(ev.pointerId); move(ev);
  });
  const move = (ev) => {
    if (!dragging) return;
    const r = c.getBoundingClientRect();
    const t = 1 - (ev.clientY - r.top - 6) / (r.height - 24);
    set(min + Math.min(1, Math.max(0, t)) * (max - min));
  };
  c.addEventListener("pointermove", move);
  c.addEventListener("pointerup", () => { dragging = false; });
  c.addEventListener("wheel", (ev) => {
    ev.preventDefault();
    set(v - Math.sign(ev.deltaY) * (max - min) / 50);
  });
  c.oncontextmenu = (ev) => { ev.preventDefault(); midi.learn({ set }, onChange, min, max); };
  c._set = set;
  draw();
  return c;
}

function makeRotary(value, min, max, onChange) {
  const c = document.createElement("canvas");
  c.width = 36; c.height = 36;
  c.className = "rotary";
  let v = value;
  const draw = () => {
    const ctx = c.getContext("2d");
    ctx.clearRect(0, 0, 36, 36);
    ctx.strokeStyle = "#39434d"; ctx.lineWidth = 4;
    ctx.beginPath(); ctx.arc(18, 18, 13, 0.75 * Math.PI, 2.25 * Math.PI); ctx.stroke();
    const t = (v - min) / (max - min);
    ctx.strokeStyle = "#6ab0f3";
    ctx.beginPath(); ctx.arc(18, 18, 13, 0.75 * Math.PI, (0.75 + 1.5 * t) * Math.PI); ctx.stroke();
    const ang = (0.75 + 1.5 * t) * Math.PI;
    ctx.beginPath(); ctx.moveTo(18, 18);
    ctx.lineTo(18 + 10 * Math.cos(ang), 18 + 10 * Math.sin(ang));
    ctx.strokeStyle = "#dde3e8"; ctx.lineWidth = 2; ctx.stroke();
  };
  const set = (nv, fire = true) => {
    v = Math.min(max, Math.max(min, nv));
    draw();
    if (fire) onChange(v);
  };
  let start = null;
  c.addEventListener("pointerdown", (ev) => {
    start = { y: ev.clientY, v }; c.setPointerCapture(ev.pointerId);
  });
  c.addEventListener("pointermove", (ev) => {
    if (!start) return;
    set(start.v + (start.y - ev.clientY) / 100 * (max - min));
  });
  c.addEventListener("pointerup", () => { start = null; });
  c.addEventListener("wheel", (ev) => {
    ev.preventDefault();
    set(v - Math.sign(ev.deltaY) * (max - min) / 50);
  });
  c.oncontextmenu = (ev) => { ev.preventDefault(); midi.learn({ set }, onChange, min, max); };
  c._set = set;
  draw();
  return c;
}

/* -------------------------------------------------------------- param UI */

function sendParams(mid, kind, params) {
  wire.send({ t: "UpdateModuleParams", module_id: mid, params: { kind, params } });
}

const moduleUI = {
  build(win, mid, params) {
    const body = win.querySelector(".body");
    const kind = params.kind;
    const p = params.params;
    const mk = (html) => { body.innerHTML = html; };
    const num = (name, value, step, cb) => {
      const el = document.createElement("label");
      el.innerHTML = `${name} <input type="number" step="${step}" value="${value}">`;
      el.querySelector("input").onchange = (ev) => cb(parseFloat(ev.target.value));
      body.appendChild(el);
      return el.querySelector("input");
    };
    const slider = (name, value, min, max, step, cb) => {
      const el = document.createElement("label");
      el.innerHTML = `${name} <input class="midi-target" type="range" min="${min}" max="${max}" step="${step}" value="${value}">`;
      const input = el.querySelector("input");
      input.oninput = (ev) => cb(parseFloat(ev.target.value));
      input.oncontextmenu = (ev) => { ev.preventDefault(); ev.stopPropagation(); midi.learn(input, cb, min, max); };
      body.appendChild(el);
      return input;
    };

    switch (kind) {
      case "Oscillator": {
        const sel = document.createElement("select");
        for (const w of ["sine", "square", "saw", "triangle", "on", "off"]) {
          sel.appendChild(new Option(w, w));
        }
        sel.value = p.waveform;
        const cur = () => session.state.modules.get(mid).params;
        sel.onchange = () => sendParams(mid, kind, { ...cur(), waveform: sel.value });
        body.appendChild(sel);
        slider("freq", p.freq, 20, 2000, 1, (v) => sendParams(mid, kind, { ...cur(), freq: v }));
        break;
      }
      case "FmSine": {
        const cur = () => session.state.modules.get(mid).params;
        num("lo", p.freq_lo, 1, (v) => sendParams(mid, kind, { ...cur(), freq_lo: v }));
        num("hi", p.freq_hi, 1, (v) => sendParams(mid, kind, { ...cur(), freq_hi: v }));
        break;
      }
      case "Amplifier": {
        const cur = () => session.state.modules.get(mid).params;
        slider("amp", p.amplitude, 0, 2, 0.01, (v) => sendParams(mid, kind, { ...cur(), amplitude: v }));
        slider("mod", p.mod_depth, 0, 1, 0.01, (v) => sendParams(mid, kind, { ...cur(), mod_depth: v }));
        break;
      }
      case "Envelope": {
        const cur = () => session.state.modules.get(mid).params;
        num("attack ms", p.attack_ms, 1, (v) => sendParams(mid, kind, { ...cur(), attack_ms: v }));
        num("decay ms", p.decay_ms, 1, (v) => sendParams(mid, kind, { ...cur(), decay_ms: v }));
        slider("sustain", p.sustain_amplitude, 0, 1, 0.01, (v) => sendParams(mid, kind, { ...cur(), sustain_amplitude: v }));
        num("release ms", p.release_ms, 1, (v) => sendParams(mid, kind, { ...cur(), release_ms: v }));
        break;
      }
      case "EqThree": {
        const cur = () => session.state.modules.get(mid).params;
        slider("lo dB", p.gain_lo, -24, 24, 0.1, (v) => sendParams(mid, kind, { ...cur(), gain_lo: v }));
        slider("mid dB", p.gain_mid, -24, 24, 0.1, (v) => sendParams(mid, kind, { ...cur(), gain_mid: v }));
        slider("hi dB", p.gain_hi, -24, 24, 0.1, (v) => sendParams(mid, kind, { ...cur(), gain_hi: v }));
        break;
      }
      case "Mixer": {
        p.channels.forEach((ch, i) => {
          const row = document.createElement("div");
          row.className = "mixer-row";
          body.appendChild(row);
          const update = (patch) => {
            const cur = session.state.modules.get(mid).params;
            const channels = cur.channels.map((c, j) => (j === i ? { ...c, ...patch } : c));
            sendParams(mid, kind, { ...cur, channels });
          };
          const g = makeRotary(ch.gain, -24, 12, (v) => update({ gain: v }));
          g.title = `ch${i + 1} gain dB`;
          const f = makeFader(ch.fader, 0, 1, (v) => update({ fader: v }));
          f.title = `ch${i + 1} fader`;
          const c = document.createElement("button");
          c.textContent = "cue"; c.className = ch.cue ? "on" : "";
          c.onclick = () => update({ cue: !session.state.modules.get(mid).params.channels[i].cue });
          row.append(`${i + 1}`, g, f, c);
        });
        break;
      }
      case "Trigger": {
        const btn = document.createElement("button");
        btn.className = "gate";
        const render = () => {
          const v = session.state.modules.get(mid).params;
          btn.textContent = v === "open" ? "ON" : "OFF";
          btn.classList.toggle("on", v === "open");
        };
        btn.onclick = () => {
          const v = session.state.modules.get(mid).params;
          sendParams(mid, kind, v === "open" ? "closed" : "open");
        };
        body.appendChild(btn);
        render();
        win._renderGate = render;
        break;
      }
      case "Plotter": {
        const canvas = document.createElement("canvas");
        canvas.width = 220; canvas.height = 90;
        body.appendChild(canvas);
        indications.subs.set(mid, (ind) => {
          if (!ind.value || !ind.value.inputs) return;
          const ctx = canvas.getContext("2d");
          ctx.fillStyle = "#101418";
          ctx.fillRect(0, 0, canvas.width, canvas.height);
          const colors = ["#6ab0f3", "#7c4"];
          ind.value.inputs.forEach((chan, ci) => {
            ctx.strokeStyle = colors[ci % 2];
            ctx.beginPath();
            chan.forEach((v, i) => {
              const x = (i / chan.length) * canvas.width;
              const y = canvas.height / 2 - v * canvas.height * 0.45;
              if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
            });
            ctx.stroke();
          });
        });
        break;
      }
      case "Monitor": {
        const img = document.createElement("img");
        img.className = "monitor-video";
        const label = document.createElement("div");
        label.className = "mini";
        const btn = document.createElement("button");
        btn.textContent = "▶ listen";
        btn.onclick = () => {
          const ind = session.state.indications.get(mid);
          if (ind && ind.value) monitorPlayers.start(mid, ind.value.socket_id, img, label);
        };
        body.append(btn, img, label);
        break;
      }
      case "StreamInput": {
        const cur = () => session.state.modules.get(mid).params;
        const proto = document.createElement("select");
        for (const v of ["", "rtmp", "icecast"]) proto.appendChild(new Option(v || "(protocol)", v));
        proto.value = p.protocol || "";
        const mount = document.createElement("input");
        mount.placeholder = "mountpoint";
        mount.value = p.mountpoint || "";
        const apply = () => sendParams(mid, kind, {
          ...cur(), protocol: proto.value || null, mountpoint: mount.value || null,
        });
        proto.onchange = apply;
        mount.onchange = apply;
        body.append(proto, mount);
        break;
      }
      case "StreamOutput": {
        const cur = () => session.state.modules.get(mid).params;
        const url = document.createElement("input");
        url.placeholder = "rtmp://host/app"; url.value = p.rtmp_url;
        const keyI = document.createElement("input");
        keyI.placeholder = "stream key"; keyI.value = p.rtmp_stream_key;
        const status = document.createElement("span"); status.className = "badge";
        const go = document.createElement("button"); go.textContent = "go live";
        const stop = document.createElement("button"); stop.textContent = "stop";
        go.onclick = () => {
          const c = cur();
          const seq = c.seq + 1;
          sendParams(mid, kind, { ...c, seq, connect_seq: seq, rtmp_url: url.value, rtmp_stream_key: keyI.value });
        };
        stop.onclick = () => {
          const c = cur();
          const seq = c.seq + 1;
          sendParams(mid, kind, { ...c, seq, disconnect_seq: seq });
        };
        indications.subs.set(mid, (ind) => {
          if (ind.value) {
            status.textContent = ind.value.live + (ind.value.error ? " (error)" : "");
            status.className = "badge " + ind.value.live;
          }
        });
        body.append(url, keyI, go, stop, status);
        break;
      }
      case "VideoMixer": {
        const cur = () => session.state.modules.get(mid).params;
        const selA = document.createElement("select");
        const selB = document.createElement("select");
        for (const sel of [selA, selB]) {
          for (const v of ["", "0", "1", "2", "3"]) sel.appendChild(new Option(v || "(none)", v));
        }
        selA.value = p.a === null ? "" : String(p.a);
        selB.value = p.b === null ? "" : String(p.b);
        const apply = (patch) => sendParams(mid, kind, { ...cur(), ...patch });
        selA.onchange = () => apply({ a: selA.value === "" ? null : parseInt(selA.value) });
        selB.onchange = () => apply({ b: selB.value === "" ? null : parseInt(selB.value) });
        slider("A/B fade", p.fader, 0, 1, 0.01, (v) => apply({ fader: v }));
        body.prepend(selA, selB);
        break;
      }
      case "MediaSource": {
        const sel = document.createElement("select");
        const fill = () => {
          sel.innerHTML = "";
          sel.appendChild(new Option("(none)", ""));
          for (const item of session.media) sel.appendChild(new Option(item.name, item.id));
          const cur = session.state.modules.get(mid).params;
          sel.value = cur.media_id === null ? "" : String(cur.media_id);
        };
        fill();
        session.onchange.push(fill);
        sel.onchange = () => sendParams(mid, kind, {
          t: "MediaSourceParams",
          media_id: sel.value === "" ? null : parseInt(sel.value),
        });
        body.appendChild(sel);
        break;
      }
      case "OutputDevice": {
        const status = document.createElement("div"); status.className = "mini";
        indications.subs.set(mid, (ind) => {
          const v = ind.value || {};
          status.textContent =
            (v.clip ? `clip:${v.clip} ` : "") + (v.lag ? `lag:${v.lag} ` : "") +
            (v.devices && v.devices.length ? "" : "no audio devices");
        });
        status.textContent = "no audio devices";
        body.appendChild(status);
        break;
      }
      default:
        mk("<div class='mini'>no parameters</div>");
    }
  },

  update(win, mid, params) {
    if (win._renderGate) win._renderGate();
  },
};

/* -------------------------------------------------------- monitor player */

const monitorPlayers = {
  players: new Map(),
  drop(mid) {
    const p = monitorPlayers.players.get(mid);
    if (p) { p.ws.close(); monitorPlayers.players.delete(mid); }
  },
  start(mid, socketId, img, label) {
    monitorPlayers.drop(mid);
    const audioCtx = new (window.AudioContext || window.webkitAudioContext)();
    const ws = new WebSocket(`ws://${location.host}/_monitor/${socketId}`);
    ws.binaryType = "arraybuffer";
    const player = { ws, cursor: 0, sampleRate: 44100, channels: 2, mse: null, queue: [] };
    monitorPlayers.players.set(mid, player);
    ws.onmessage = (ev) => {
      const buf = new Uint8Array(ev.data);
      const nl = buf.indexOf(10);
      const header = JSON.parse(new TextDecoder().decode(buf.subarray(0, nl)));
      const payload = buf.subarray(nl + 1);
      if (header.t === "init" && header.mode === "fmp4") {
        // MSE playback, matching the reference's monitor player
        // (frontend/src/module/monitor.rs:164-248)
        const video = document.createElement("video");
        video.autoplay = true; video.muted = false; video.controls = true;
        video.className = "monitor-video";
        img.replaceWith(video);
        const mse = new MediaSource();
        video.src = URL.createObjectURL(mse);
        mse.addEventListener("sourceopen", () => {
          const sb = mse.addSourceBuffer(header.mime);
          player.mse = sb;
          sb.addEventListener("updateend", () => {
            if (player.queue.length && !sb.updating) sb.appendBuffer(player.queue.shift());
          });
          sb.appendBuffer(payload);
        });
        label.textContent = "fmp4/MSE";
      } else if (header.t === "segment") {
        if (player.mse) {
          if (player.mse.updating || player.queue.length) player.queue.push(payload);
          else player.mse.appendBuffer(payload);
        }
      } else if (header.t === "init") {
        player.sampleRate = header.sample_rate;
        player.channels = header.channels;
        label.textContent = `${header.mode} ${header.sample_rate} Hz`;
      } else if (header.t === "audio") {
        const i16 = new Int16Array(payload.buffer, payload.byteOffset, payload.byteLength / 2);
        const frames = i16.length / player.channels;
        const ab = audioCtx.createBuffer(player.channels, frames, player.sampleRate);
        for (let c = 0; c < player.channels; c++) {
          const chan = ab.getChannelData(c);
          for (let i = 0; i < frames; i++) chan[i] = i16[i * player.channels + c] / 32768;
        }
        const src = audioCtx.createBufferSource();
        src.buffer = ab;
        src.connect(audioCtx.destination);
        if (player.cursor < audioCtx.currentTime) player.cursor = audioCtx.currentTime + 0.05;
        src.start(player.cursor);
        player.cursor += frames / player.sampleRate;
      } else if (header.t === "video") {
        const blob = new Blob([payload], { type: "image/png" });
        const u = URL.createObjectURL(blob);
        img.onload = () => URL.revokeObjectURL(u);
        img.src = u;
      }
    };
  },
};

/* ------------------------------------------------------------------ MIDI */

const midi = {
  access: null,
  learning: null, // {apply, min, max}
  mappings: JSON.parse(localStorage.getItem("midi-map") || "{}"),

  async init() {
    if (!navigator.requestMIDIAccess) return;
    try {
      midi.access = await navigator.requestMIDIAccess();
    } catch (e) { return; }
    for (const input of midi.access.inputs.values()) {
      input.onmidimessage = midi.onMessage;
    }
  },

  learn(input, apply, min, max) {
    midi.learning = { input, apply, min, max };
    setStatus("MIDI learn: move a controller…");
  },

  onMessage(ev) {
    const [statusByte, cc, value] = ev.data;
    if ((statusByte & 0xf0) !== 0xb0) return; // CC range messages (midi.rs:216+)
    const keyName = `cc${cc}`;
    if (midi.learning) {
      const { input, apply, min, max } = midi.learning;
      midi.mappings[keyName] = { min, max };
      midi._live = midi._live || {};
      midi._live[keyName] = { input, apply, min, max };
      midi.learning = null;
      setStatus(`mapped CC ${cc}`);
      localStorage.setItem("midi-map", JSON.stringify(midi.mappings));
      return;
    }
    const live = midi._live && midi._live[keyName];
    if (live) {
      const v = live.min + (value / 127) * (live.max - live.min);
      if (live.input.set) live.input.set(v);           // canvas controls
      else { live.input.value = v; live.apply(v); }    // native inputs
    }
  },
};

/* --------------------------------------------------------------- sidebar */

const sidebar = {
  render() {
    const el = document.getElementById("perf");
    const p = session.perf;
    if (!p) { el.innerHTML = ""; return; }
    const rows = (p.accounts || []).map(([acct, metric]) => {
      const name = acct === "engine" ? "engine" : `module ${acct.module}`;
      return `<tr><td>${name}</td><td>${metric.last} µs</td></tr>`;
    }).join("");
    el.innerHTML = `
      <div>realtime: <b class="${p.realtime ? "ok" : "warn"}">${p.realtime}</b>
        ${p.lag ? `<span class="badge warn">lag ${p.lag}</span>` : ""}</div>
      <div class="mini">budget ${p.tick_budget} µs @ ${p.tick_rate} Hz</div>
      <table>${rows}</table>`;
  },
};

/* --------------------------------------------------------------- library */

const library = {
  render() {
    const el = document.getElementById("library-list");
    if (!el) return;
    el.innerHTML = session.media.map((m) =>
      `<div class="media-item">${m.name} <span class="mini">${m.kind}, ${m.size} B</span></div>`
    ).join("") || "<div class='mini'>no media yet</div>";
  },
  async upload(file) {
    setStatus(`uploading ${file.name}…`);
    await fetch(`/_upload/${encodeURIComponent(file.name)}`, {
      method: "POST",
      headers: { "Content-Type": file.type || "application/octet-stream" },
      body: file,
    });
    setStatus(`uploaded ${file.name}`);
  },
};

/* ------------------------------------------------------------------ init */

window.addEventListener("DOMContentLoaded", () => {
  workspace.init();
  session.connect();
  midi.init();
  document.getElementById("upload").addEventListener("change", (ev) => {
    for (const f of ev.target.files) library.upload(f);
  });
  for (const tab of document.querySelectorAll(".tab")) {
    tab.onclick = () => {
      for (const t of document.querySelectorAll(".tab")) t.classList.remove("active");
      tab.classList.add("active");
      document.getElementById("workspace-view").style.display =
        tab.dataset.view === "workspace" ? "block" : "none";
      document.getElementById("library-view").style.display =
        tab.dataset.view === "library" ? "block" : "none";
    };
  }
});
