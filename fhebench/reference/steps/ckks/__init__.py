"""Plain CKKS operations.  Each module gives slots(z, args, plain): the
slots after one part of the operation on slots z, where args is that part's
record and plain the operation's own plain inputs for the pool item."""
