// @ts-check
/**
 * Minimal component runtime for the typed client variant.
 *
 * The reference's second client is React 18 + Vite
 * (addons/gst-web-react); this image has no node/npm, so a Vite build
 * cannot exist. This ~90-line runtime supplies the two React idioms the
 * variant actually needs — h() element construction and useState-driven
 * re-render of pure component functions — with zero dependencies, so the
 * variant ships runnable from the same static server as everything else.
 * Types ride on JSDoc and are checkable with `tsc -p .` wherever a
 * TypeScript compiler exists (tsconfig.json in this directory).
 */
"use strict";

/**
 * @param {string} tag
 * @param {Record<string, unknown> | null} props
 * @param {...(Node | string | null | undefined | false)} children
 * @returns {HTMLElement}
 */
export function h(tag, props, ...children) {
  const el = document.createElement(tag);
  for (const [k, v] of Object.entries(props || {})) {
    if (k.startsWith("on") && typeof v === "function") {
      el.addEventListener(k.slice(2).toLowerCase(), /** @type {EventListener} */ (v));
    } else if (k === "style" && typeof v === "object" && v) {
      Object.assign(el.style, v);
    } else if (k === "class") {
      el.className = String(v);
    } else if (v !== false && v != null) {
      el.setAttribute(k, String(v));
    }
  }
  for (const c of children) {
    if (c == null || c === false) continue;
    el.append(c instanceof Node ? c : document.createTextNode(String(c)));
  }
  return el;
}

/** @type {{states: unknown[], i: number, render: () => void} | null} */
let _ctx = null;

/**
 * useState for the CURRENT component render pass.
 * @template T
 * @param {T} initial
 * @returns {[T, (next: T) => void]}
 */
export function useState(initial) {
  const ctx = _ctx;
  if (!ctx) throw new Error("useState outside render");
  const i = ctx.i++;
  if (ctx.states.length <= i) ctx.states.push(initial);
  const set = (/** @type {T} */ next) => {
    if (ctx.states[i] !== next) {
      ctx.states[i] = next;
      ctx.render();
    }
  };
  return [/** @type {T} */ (ctx.states[i]), set];
}

/**
 * Mount a component function into a container; re-renders whenever any
 * of its useState setters fire. Event wiring to the outside world goes
 * through the props object.
 * @template P
 * @param {(props: P) => HTMLElement} component
 * @param {P} props
 * @param {HTMLElement} container
 * @returns {() => void} forced re-render
 */
export function mount(component, props, container) {
  /** @type {{states: unknown[], i: number, render: () => void}} */
  const ctx = { states: [], i: 0, render: () => {} };
  const render = () => {
    ctx.i = 0;
    const prev = _ctx;
    _ctx = ctx;
    try {
      const tree = component(props);
      container.replaceChildren(tree);
    } finally {
      _ctx = prev;
    }
  };
  ctx.render = render;
  render();
  return render;
}
