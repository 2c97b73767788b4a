/* session_core.js — pure session-mirror logic, no DOM, no WebSocket.
 *
 * Mirrors the reference's frontend/src/session.rs:
 *   - local WorkspaceState mirror kept in Maps (session.rs:110-177)
 *   - optimistic concurrency: client ops carry an increasing sequence;
 *     the server echoes Sync(seq) when an op is applied
 *   - RENDER GATING (session.rs:83-108): server updates are always applied
 *     to the mirror, but re-renders from server state only fire when every
 *     local op has round-tripped (server seq == client seq); the Sync that
 *     achieves catch-up fires the deferred render.
 *
 * Loaded before app.js in the browser; executed under test by the
 * mixlab_tpu.utils.jsmini interpreter (this image has no JS runtime).
 */

function sessionKey(idArr) { return idArr.join(":"); }

/* Terminals arrive on the wire as [label, lineType] pairs
 * (protocol/wire.py:79-80); accept the object form too for robustness. */
function terminalLineType(term) {
  if (Array.isArray(term)) return term[1];
  return term && term.line_type;
}

function makeSessionCore(hooks) {
  // hooks: {
  //   render(),                      -- workspace re-render
  //   onIndication(moduleId, ind),   -- targeted indication dispatch
  //   onPerformance(perf),
  //   onMediaLibrary(items),
  //   geometryHeld(moduleId) -> bool -- true while the user drags a window
  //   onDeleteModule(moduleId),
  // }
  const h = hooks || {};
  const call = (name, ...args) => { if (h[name]) return h[name](...args); };

  const core = {
    state: null,
    pendingSeq: 0, // last client sequence sent
    syncedSeq: 0,  // last client sequence the server confirmed
    media: [],
    perf: null,

    nextSeq() {
      core.pendingSeq += 1;
      return core.pendingSeq;
    },

    caughtUp() {
      // session.rs:93-108 workspace_synced()
      return core.syncedSeq >= core.pendingSeq;
    },

    onMessage(msg) {
      if (msg.kind === "WorkspaceState") {
        const st = msg.m;
        const s = {
          modules: new Map(), geometry: new Map(), indications: new Map(),
          connections: new Map(), inputs: new Map(), outputs: new Map(),
        };
        for (const [id, params] of st.modules) s.modules.set(id, params);
        for (const [id, g] of st.geometry) s.geometry.set(id, g);
        for (const [id, ind] of st.indications) s.indications.set(id, ind);
        for (const [inp, out] of st.connections) s.connections.set(sessionKey(inp), out);
        for (const [id, terms] of st.inputs) s.inputs.set(id, terms);
        for (const [id, terms] of st.outputs) s.outputs.set(id, terms);
        core.state = s;
        call("render"); // full snapshot always renders (session.rs:112-116)
      } else if (msg.kind === "Update") {
        const rendered = core.applyUpdate(msg.m);
        // gate: render only when the server has caught up to our edits
        // (session.rs:168-177)
        if (rendered && core.caughtUp()) call("render");
      } else if (msg.kind === "Sync") {
        const was = core.caughtUp();
        core.syncedSeq = Math.max(core.syncedSeq, msg.m);
        // the Sync that catches us up renders any gated updates
        // (session.rs:117-126)
        if (!was && core.caughtUp()) call("render");
      } else if (msg.kind === "Performance") {
        core.perf = msg.m;
        call("onPerformance", msg.m);
      } else if (msg.kind === "MediaLibrary") {
        core.media = msg.m.items || [];
        call("onMediaLibrary", core.media);
      }
    },

    // -> true when the update warrants a workspace re-render
    applyUpdate(u) {
      const s = core.state;
      if (!s) return false;
      switch (u.t) {
        case "SUCreateModule":
          s.modules.set(u.id, u.params);
          s.geometry.set(u.id, u.geometry);
          s.indications.set(u.id, u.indication);
          s.inputs.set(u.id, u.inputs);
          s.outputs.set(u.id, u.outputs);
          return true;
        case "SUUpdateModuleParams":
          s.modules.set(u.module_id, u.params);
          return true;
        case "SUUpdateWindowGeometry":
          if (!call("geometryHeld", u.module_id)) {
            s.geometry.set(u.module_id, u.geometry);
            return true;
          }
          return false;
        case "SUUpdateModuleIndication":
          s.indications.set(u.module_id, u.indication);
          call("onIndication", u.module_id, u.indication);
          return false; // targeted dispatch, no full re-render
        case "SUDeleteModule":
          for (const m of [s.modules, s.geometry, s.indications, s.inputs, s.outputs]) {
            m.delete(u.module_id);
          }
          call("onDeleteModule", u.module_id);
          return true;
        case "SUCreateConnection":
          s.connections.set(sessionKey(u.input_id), u.output_id);
          return true;
        case "SUDeleteConnection":
          s.connections.delete(sessionKey(u.input_id));
          return true;
        default:
          return false;
      }
    },

    // line-type-checked connect test, mirroring workspace.rs:97-114 so the
    // client can reject invalid wires without a server round-trip
    canConnect(outModuleId, outIdx, inModuleId, inIdx) {
      const s = core.state;
      if (!s) return false;
      const outs = s.outputs.get(outModuleId);
      const ins = s.inputs.get(inModuleId);
      if (!outs || !ins || outIdx >= outs.length || inIdx >= ins.length) return false;
      const a = terminalLineType(outs[outIdx]);
      const b = terminalLineType(ins[inIdx]);
      return a !== undefined && a === b;
    },
  };
  return core;
}

/* Connect-flow state machine, mirroring the reference's terminal mouse
 * handling (frontend/src/workspace.rs:185-252 + 588-600):
 *   - left mousedown on a terminal enters Connect mode; a second left
 *     mousedown on an opposite-direction terminal with a matching line
 *     type sends CreateConnection (SelectTerminal, workspace.rs:185-220);
 *     type mismatch or same-direction picks keep Connect mode
 *     (workspace.rs:208-215)
 *   - right mousedown clears: an input's connection, or ALL connections
 *     from an output (ClearTerminal, workspace.rs:222-252)
 *   - the live wire endpoint tracks the cursor while connecting
 *     (workspace.rs:173-178, 341-348)
 * Pure logic, no DOM: app.js renders flow.pending/flow.cursor. */
function makeConnectFlow(core, send) {
  const flow = {
    pending: null, // {mid, idx, dir, lineType}
    cursor: null,  // {x, y} live-wire endpoint

    /* left mousedown on terminal -> "pending" | "connected" | "mismatch"
     * | "invalid" */
    select(mid, idx, dir, lineType) {
      if (!flow.pending) {
        flow.pending = { mid: mid, idx: idx, dir: dir, lineType: lineType };
        return "pending";
      }
      const p = flow.pending;
      if (p.dir === dir) return "invalid";       // need one input + one output
      if (p.lineType !== lineType) return "mismatch";
      const inp = dir === "in" ? [mid, idx] : [p.mid, p.idx];
      const out = dir === "out" ? [mid, idx] : [p.mid, p.idx];
      send({ t: "CreateConnection", input_id: inp, output_id: out });
      flow.pending = null;
      flow.cursor = null;
      return "connected";
    },

    /* right mousedown on terminal -> number of connections cleared */
    clear(mid, idx, dir) {
      const s = core.state;
      if (!s) return 0;
      let n = 0;
      if (dir === "in") {
        if (s.connections.has(sessionKey([mid, idx]))) {
          send({ t: "DeleteConnection", input_id: [mid, idx] });
          n = 1;
        }
      } else {
        for (const [inpKey, out] of s.connections) {
          if (out[0] === mid && out[1] === idx) {
            send({ t: "DeleteConnection",
                   input_id: inpKey.split(":").map((v) => parseInt(v, 10)) });
            n += 1;
          }
        }
      }
      return n;
    },

    /* terminal mousedown dispatcher (buttons as in MouseEvent.buttons) */
    down(mid, idx, dir, lineType, buttons) {
      if ((buttons & 2) !== 0) return "cleared:" + flow.clear(mid, idx, dir);
      return flow.select(mid, idx, dir, lineType);
    },

    move(x, y) {
      if (flow.pending) flow.cursor = { x: x, y: y };
    },

    cancel() {
      flow.pending = null;
      flow.cursor = null;
    },
  };
  return flow;
}

/* CommonJS export for the test interpreter; browsers use the globals. */
if (typeof module !== "undefined" && module.exports) {
  module.exports = { makeSessionCore, makeConnectFlow, sessionKey, terminalLineType };
}
