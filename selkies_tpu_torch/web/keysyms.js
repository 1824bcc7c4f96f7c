/* KeyboardEvent → X11 keysym translation.
 *
 * Fresh implementation of what the reference client vendors guacamole
 * for (addons/gst-web/src/lib/guacamole-keyboard-selkies.js): printable
 * characters map through their Unicode codepoint (Latin-1 keysyms equal
 * the codepoint; others use the 0x01000000+cp convention); everything
 * else resolves through the tables below, with KeyboardEvent.location
 * distinguishing left/right modifiers and the numpad. Keysym values are
 * the standard X11 keysymdef constants.
 *
 * International depth:
 *  - dead keys: ev.key === "Dead" says WHICH accent only through the
 *    physical code + modifier state; DEAD_BY_CODE covers the dead-key
 *    positions of the common European layouts (US-intl, DE, FR, ES,
 *    PT, Nordic) so the server's own input method composes correctly.
 *    Composed text entered through an IME still arrives complete via
 *    the compositionend path (input.js).
 *  - keyup reliability: translating the keyup event re-reads the
 *    LAYOUT AT RELEASE TIME, which desyncs when modifiers or layouts
 *    change mid-hold (the classic stuck-key bug). KeyTracker remembers
 *    the keysym pressed per physical code and releases exactly that.
 *  - legacy fallback: events without `key` (very old engines,
 *    synthetic dispatches) resolve through keyCode.
 */
"use strict";

const KEYSYMS_BY_KEY = {
  // editing / navigation
  "Backspace": 0xff08, "Tab": 0xff09, "Clear": 0xff0b, "Enter": 0xff0d,
  "Escape": 0xff1b, "Delete": 0xffff, "Home": 0xff50, "End": 0xff57,
  "PageUp": 0xff55, "PageDown": 0xff56, "ArrowLeft": 0xff51,
  "ArrowUp": 0xff52, "ArrowRight": 0xff53, "ArrowDown": 0xff54,
  "Insert": 0xff63, "Undo": 0xff65, "Redo": 0xff66, "Find": 0xff68,
  "Cancel": 0xff69, "Help": 0xff6a, "Select": 0xff60, "Execute": 0xff62,
  "Again": 0xff66, "Props": 0x1005ff70, "EraseEof": 0xfd06,
  "CrSel": 0xfd1c, "ExSel": 0xfd1d, "Attn": 0xfd0e, "Play": 0xfd16,
  // locks / system
  "Pause": 0xff13, "ScrollLock": 0xff14, "SysReq": 0xff15,
  "PrintScreen": 0xff61, "CapsLock": 0xffe5, "NumLock": 0xff7f,
  "ContextMenu": 0xff67, "Standby": 0x1008ff10,
  // modifiers (left variants; location fixes the right side)
  "Shift": 0xffe1, "Control": 0xffe3, "Alt": 0xffe9, "AltGraph": 0xfe03,
  "Meta": 0xffe7, "OS": 0xffe7, "Super": 0xffeb, "Hyper": 0xffed,
  "ModeChange": 0xff7e, "Win": 0xffeb,
  // function keys
  "F1": 0xffbe, "F2": 0xffbf, "F3": 0xffc0, "F4": 0xffc1, "F5": 0xffc2,
  "F6": 0xffc3, "F7": 0xffc4, "F8": 0xffc5, "F9": 0xffc6, "F10": 0xffc7,
  "F11": 0xffc8, "F12": 0xffc9, "F13": 0xffca, "F14": 0xffcb,
  "F15": 0xffcc, "F16": 0xffcd, "F17": 0xffce, "F18": 0xffcf,
  "F19": 0xffd0, "F20": 0xffd1, "F21": 0xffd2, "F22": 0xffd3,
  "F23": 0xffd4, "F24": 0xffd5,
  "Soft1": 0xffd2, "Soft2": 0xffd3, "Soft3": 0xffd4, "Soft4": 0xffd5,
  // IME / language (W3C key values → X keysyms)
  "Compose": 0xff20, "Convert": 0xff23, "NonConvert": 0xff22,
  "KanaMode": 0xff2d, "HiraganaKatakana": 0xff27, "Hiragana": 0xff25,
  "Katakana": 0xff26, "Zenkaku": 0xff28, "Hankaku": 0xff29,
  "ZenkakuHankaku": 0xff2a, "Romaji": 0xff24, "KanjiMode": 0xff21,
  "HangulMode": 0xff31, "HanjaMode": 0xff34, "Eisu": 0xff2f,
  "JunjaMode": 0xff38, "FinalMode": 0xff3c, "CodeInput": 0xff37,
  "AllCandidates": 0xff3d, "PreviousCandidate": 0xff3e,
  "SingleCandidate": 0xff3c, "GroupNext": 0xfe08, "GroupPrevious": 0xfe0a,
  // dead keys (generic; DEAD_BY_CODE below refines WHICH accent)
  "Dead": 0xfe50,
  // media / browser keys (XF86 keysym block 0x1008ffxx)
  "AudioVolumeMute": 0x1008ff12, "AudioVolumeDown": 0x1008ff11,
  "AudioVolumeUp": 0x1008ff13, "MediaPlayPause": 0x1008ff14,
  "MediaStop": 0x1008ff15, "MediaTrackPrevious": 0x1008ff16,
  "MediaTrackNext": 0x1008ff17, "MediaPlay": 0x1008ff14,
  "MediaPause": 0x1008ff31, "MediaRecord": 0x1008ff1f,
  "MediaFastForward": 0x1008ff97, "MediaRewind": 0x1008ff3e,
  "BrowserBack": 0x1008ff26, "BrowserForward": 0x1008ff27,
  "BrowserRefresh": 0x1008ff29, "BrowserStop": 0x1008ff28,
  "BrowserSearch": 0x1008ff1b, "BrowserFavorites": 0x1008ff30,
  "BrowserHome": 0x1008ff18, "LaunchMail": 0x1008ff19,
  "LaunchApplication1": 0x1008ff1c, "LaunchApplication2": 0x1008ff1d,
  "LaunchCalculator": 0x1008ff1d, "LaunchMediaPlayer": 0x1008ff32,
  "Eject": 0x1008ff2c, "Sleep": 0x1008ff2f, "WakeUp": 0x1008ff2b,
  "Power": 0x1008ff2a, "BrightnessUp": 0x1008ff02,
  "BrightnessDown": 0x1008ff03, "Copy": 0x1008ff57, "Cut": 0x1008ff58,
  "Paste": 0x1008ff6d, "Open": 0x1008ff6b, "Save": 0x1008ff77,
  "Print": 0xff61, "ZoomIn": 0x1008ff8b, "ZoomOut": 0x1008ff8c,
  "Close": 0x1008ff56, "New": 0x1008ff68, "Spell": 0x1008ff7c,
};

// location === 2 (right-hand modifiers)
const KEYSYMS_RIGHT = {
  "Shift": 0xffe2, "Control": 0xffe4, "Alt": 0xffea, "Meta": 0xffe8,
  "OS": 0xffe8, "Super": 0xffec, "Hyper": 0xffee,
};

// location === 3 (numpad): KP_ keysyms keep applications that
// distinguish the keypad (games, terminals with keypad modes) working.
const KEYSYMS_NUMPAD = {
  "0": 0xffb0, "1": 0xffb1, "2": 0xffb2, "3": 0xffb3, "4": 0xffb4,
  "5": 0xffb5, "6": 0xffb6, "7": 0xffb7, "8": 0xffb8, "9": 0xffb9,
  ".": 0xffae, ",": 0xffac, "+": 0xffab, "-": 0xffad, "*": 0xffaa,
  "/": 0xffaf, "=": 0xffbd, "Enter": 0xff8d, "Home": 0xff95,
  "End": 0xff9c, "PageUp": 0xff9a, "PageDown": 0xff9b,
  "ArrowLeft": 0xff96, "ArrowUp": 0xff97, "ArrowRight": 0xff98,
  "ArrowDown": 0xff99, "Insert": 0xff9e, "Delete": 0xff9f,
  "Clear": 0xff9d, "Tab": 0xff89, " ": 0xff80,
};

/* Dead-key resolution: KeyboardEvent.key === "Dead" names the accent
 * only through the physical code + shift/altgr state. This table maps
 * the dead-key POSITIONS of the common European layouts to X11 dead_*
 * keysyms: [plain, shifted, altgr] (null = not a dead key there; the
 * generic 0xfe50 dead_grave fallback applies). A position used by
 * several layouts lists the overwhelmingly common assignment — the
 * composed TEXT still arrives correctly through compositionend even
 * when a niche layout differs; this only shapes live accent feedback.
 */
const DEAD_BY_CODE = {
  // US-international / PT / BR: ' " ` ~ ^ on Quote/Backquote/Key6
  "Quote":        [0xfe51, 0xfe57, null],   // dead_acute / dead_diaeresis
  "Backquote":    [0xfe50, 0xfe53, null],   // dead_grave / dead_tilde
  "Digit6":       [null,  0xfe52, null],    // dead_circumflex (US-intl ^)
  // DE: ´ ` on Equal-position key, ^ on Backquote
  "Equal":        [0xfe51, 0xfe50, null],   // dead_acute / dead_grave
  "Minus":        [null,  null,  0xfe53],   // dead_tilde (AltGr, several)
  // FR / BE: ^ ¨ on BracketLeft
  "BracketLeft":  [0xfe52, 0xfe57, null],   // dead_circumflex / diaeresis
  "BracketRight": [0xfe53, 0xfe52, 0xfe50], // ES: ´ ¨ / Nordic variants
  // Nordic: ¨ ^ ~ on BracketRight-position, ´ ` on Equal handled above
  "Semicolon":    [0xfe57, 0xfe52, null],   // some layouts
  "IntlBackslash":[null,  null,  0xfe50],
};

function deadKeysym(ev) {
  const row = DEAD_BY_CODE[ev.code];
  if (row) {
    const idx = ev.getModifierState && ev.getModifierState("AltGraph") ? 2
      : (ev.shiftKey ? 1 : 0);
    if (row[idx]) return row[idx];
    if (row[0]) return row[0];
  }
  return KEYSYMS_BY_KEY["Dead"];
}

/* Legacy keyCode fallback for events without `key` (old engines,
 * synthetic dispatches): letters/digits map through their ASCII
 * identity, the rest through the classic keyCode assignments. */
const KEYSYMS_BY_KEYCODE = {
  8: 0xff08, 9: 0xff09, 12: 0xff0b, 13: 0xff0d, 16: 0xffe1, 17: 0xffe3,
  18: 0xffe9, 19: 0xff13, 20: 0xffe5, 27: 0xff1b, 32: 0x20, 33: 0xff55,
  34: 0xff56, 35: 0xff57, 36: 0xff50, 37: 0xff51, 38: 0xff52, 39: 0xff53,
  40: 0xff54, 44: 0xff61, 45: 0xff63, 46: 0xffff, 91: 0xffeb, 92: 0xffec,
  93: 0xff67, 144: 0xff7f, 145: 0xff14,
};
function keysymFromLegacy(ev) {
  const kc = ev.keyCode || ev.which || 0;
  if (!kc) return null;
  const mapped = KEYSYMS_BY_KEYCODE[kc];
  if (mapped !== undefined) return mapped;
  if (kc >= 112 && kc <= 135) return 0xffbe + (kc - 112);  // F1..F24
  if (kc >= 96 && kc <= 105) return 0xffb0 + (kc - 96);    // numpad 0-9
  if (kc >= 65 && kc <= 90) {                              // letters
    return ev.shiftKey ? kc : kc + 32;
  }
  if (kc >= 48 && kc <= 57) return kc;                     // digits
  return null;
}

function keysymFromEvent(ev) {
  const key = ev.key;
  if (key === undefined) return keysymFromLegacy(ev);
  if (ev.location === 3) {
    const kp = KEYSYMS_NUMPAD[key];
    if (kp !== undefined) return kp;
  }
  if (key.length === 1) {
    const cp = key.codePointAt(0);
    if (cp >= 0x20 && cp <= 0xff) return cp;          // Latin-1 direct
    if (cp >= 0x100) return 0x01000000 + cp;          // Unicode keysym
    return cp;
  }
  if (key.length === 2 && key.codePointAt(0) >= 0xd800) {
    return 0x01000000 + key.codePointAt(0);           // astral plane pair
  }
  if (key === "Dead") return deadKeysym(ev);
  if (ev.location === 2 && KEYSYMS_RIGHT[key] !== undefined) return KEYSYMS_RIGHT[key];
  const sym = KEYSYMS_BY_KEY[key];
  return sym === undefined ? null : sym;
}

/* Keysym for one Unicode codepoint (composition / clipboard typing). */
function keysymFromCodepoint(cp) {
  if (cp >= 0x20 && cp <= 0xff) return cp;
  if (cp === 0x0a || cp === 0x0d) return 0xff0d;      // newline -> Return
  if (cp === 0x09) return 0xff09;
  return 0x01000000 + cp;
}

/* Pressed-key bookkeeping: release exactly the keysym that was pressed
 * for each physical key, even if modifiers/layout changed mid-hold
 * (re-translating the keyup event is the classic stuck-key bug), and
 * release everything on focus loss. */
class KeyTracker {
  constructor() { this._down = new Map(); }
  /* -> keysym to send for this event, or null to ignore. */
  down(ev) {
    const sym = keysymFromEvent(ev);
    if (sym === null) return null;
    this._down.set(ev.code || ("kc" + (ev.keyCode || 0)), sym);
    return sym;
  }
  up(ev) {
    const id = ev.code || ("kc" + (ev.keyCode || 0));
    const remembered = this._down.get(id);
    if (remembered !== undefined) {
      this._down.delete(id);
      return remembered;
    }
    return keysymFromEvent(ev);
  }
  /* Focus lost: every held key must release (-> list of keysyms). */
  releaseAll() {
    const syms = [...this._down.values()];
    this._down.clear();
    return syms;
  }
}
