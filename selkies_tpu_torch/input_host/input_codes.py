"""Linux input event codes used by the virtual gamepad and uinput proxy.

The port's copy of ``selkies_tpu/input_host/input_codes.py``, unchanged.

Constants from the kernel's uapi ``input-event-codes.h`` (reference
counterpart: input_event_codes.py) — only the subset the gamepad mapping
and mouse proxy need.
"""

# event types
EV_SYN = 0x00
EV_KEY = 0x01
EV_REL = 0x02
EV_ABS = 0x03

# relative axes
REL_X = 0x00
REL_Y = 0x01
REL_WHEEL = 0x08

# mouse buttons
BTN_LEFT = 0x110
BTN_RIGHT = 0x111
BTN_MIDDLE = 0x112

# gamepad buttons
BTN_GAMEPAD = 0x130
BTN_A = 0x130
BTN_B = 0x131
BTN_C = 0x132
BTN_X = 0x133
BTN_Y = 0x134
BTN_Z = 0x135
BTN_TL = 0x136
BTN_TR = 0x137
BTN_TL2 = 0x138
BTN_TR2 = 0x139
BTN_SELECT = 0x13A
BTN_START = 0x13B
BTN_MODE = 0x13C
BTN_THUMBL = 0x13D
BTN_THUMBR = 0x13E

# absolute axes
ABS_X = 0x00
ABS_Y = 0x01
ABS_Z = 0x02
ABS_RX = 0x03
ABS_RY = 0x04
ABS_RZ = 0x05
ABS_THROTTLE = 0x06
ABS_RUDDER = 0x07
ABS_HAT0X = 0x10
ABS_HAT0Y = 0x11
