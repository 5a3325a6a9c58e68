"""Plain references of what the renderer produces, one module a kind of
configuration (named by the configuration's ``reference`` key). They
import nothing of the renderer."""
